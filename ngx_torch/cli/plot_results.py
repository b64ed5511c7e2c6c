"""Learning-curve plotting from monitor CSVs — the reference's
``tests/plot_results.py`` rebuilt over :mod:`ngx_torch.utils.monitor`; the
port of ``ngx/cli/plot_results.py``.

    python -m ngx_torch.cli.plot_results -log results -agents bow pogo \\
        -out lc.png

matplotlib is imported inside :func:`main`, so the module imports where it
is not installed.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-log", default="results")
    p.add_argument("-agents", nargs="*", default=None,
                   help="subdirectories of -log to plot (default: all)")
    p.add_argument("-xaxis", default="timesteps",
                   choices=["timesteps", "episodes", "walltime_hrs"])
    p.add_argument("-every", type=int, default=1)
    p.add_argument("-out", default="")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.monitor import load_results, ts2xy

    agents = args.agents
    if not agents:
        agents = [d for d in sorted(os.listdir(args.log))
                  if os.path.isdir(os.path.join(args.log, d))] or ["."]

    plt.figure()
    curves = {}
    for agent in agents:
        rows = load_results(os.path.join(args.log, agent))
        if not rows:
            print("no monitor rows for", agent)
            continue
        x, y = ts2xy(rows, args.xaxis)
        curves[agent] = (x[::args.every], y[::args.every])
        plt.plot(*curves[agent], label=f"{agent} ({len(y)} eps)")
        print(f"agent {agent}: {len(y)} episodes")

    plt.title("Learning Curve")
    plt.ylabel("Episodes Rewards")
    plt.xlabel(args.xaxis.capitalize())
    plt.legend()
    out = args.out or os.path.join(args.log, "learning_curve.png")
    plt.savefig(out, bbox_inches="tight", dpi=100)
    plt.close()
    print("saved", out)
    return curves


if __name__ == "__main__":
    main()
