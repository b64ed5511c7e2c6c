"""Run one cell of the benchmark of ``ngx_torch`` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json`` at the root of the
checkout.  Set-up (imports, the kernels' build or load, the program's
objects from the seed, the cell's first steps) is timed as ``setup_s``.
``--trace 0`` then runs the measured window for ``--seconds`` and prints
the cell's end-to-end metrics; ``--trace 1`` runs the traced blocks (in a
train cell after a window of ``--seconds``) and prints its per-layer
metrics with the device's busy time and a breakdown.
Either way the reference then judges what the timed path produced, and the
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, (traced) ``breakdown``
and, last, ``checks``, each compared number beside its limit (also the
last lines of standard error).

Exit codes: 0 with a result; 2 when the run cannot start (no card, too
few cards, a file or the program missing), with no result; 3 when a
forbidden module (JAX, or the JAX package) was loaded, with no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # a library that the program might use must not load JAX by itself
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness, trace

    try:
        bench = harness.load_benchmark(ROOT)
        cell = harness.find_cell(bench, args.workload, ROOT)
        harness.require_cards(int(cell["cell"]["chips"]))
        import torch

        try:
            import ngx_torch  # noqa: F401
        except ImportError as e:
            raise harness.SetupError(f"the program is not here: {e}")
        runner = harness.load_runner(cell["traffic"])
    except harness.SetupError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    c = runner.Cell(cell["config"], cell["traffic"], args.seed, device)
    torch.cuda.synchronize(device)
    ctx = dict(setup_s=time.perf_counter() - T_START, seconds=args.seconds)
    # set-up's objects are kept out of the collector's work in the window
    gc.collect()
    gc.freeze()
    if args.trace:
        c.trace(ctx, trace.profile)
        entries = cell["per_layer"]
    else:
        c.window(args.seconds, ctx)
        entries = cell["end_to_end"]
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    ctx["memory_peak_bytes"] = peak
    metrics = harness.read_metrics(entries, ctx, ROOT)
    c.release()
    numbers = c.check()
    correct, checks = harness.judge(numbers, cell["limits"])

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(cell["cell"]["chips"]),
           "device_count": torch.cuda.device_count(),
           "memory_peak_bytes": peak,
           "power": harness.card_power_limit()}
    result = {"correct": correct, "attempted": ctx.get("attempted", 0),
              "failed": ctx.get("failed", 0), "metrics": metrics,
              "device": dev}
    if args.trace:
        tr = ctx["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    for name, c_ in checks.items():
        print(f"check {name}: {c_['value']!r} (limit {c_['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
