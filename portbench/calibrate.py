"""Readings for the limits of ``correct``: the numbers a cell compares, on
many seeds, for the program and for its stand-ins (the reference in the
program's place: the control, or with a planted fault).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 \\
        --mode program control half alter unchanged [--seconds 2]

One JSON line per seed and mode on standard output: ``{"workload",
"seed", "mode", "numbers", "seconds"}``.  ``program`` runs the cell as a
run does: set-up, a window of ``--seconds`` (which runs on until the calls
or evaluations the check samples exist), then the check.  Any other mode
is the cell's runner's ``standin``: ``control`` puts the reference in the
program's place in the precision below the configuration's (TF32, or
bfloat16 reward sums for stepping), and each name of the runner's
``FAULTS`` plants that fault (the train mixes: ``half``, ``alter``,
``unchanged``; under a novelty also ``pool``).  The benchmark's own runs
never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(config, traffic, seed, mode, device, seconds) -> dict:
    """The numbers of the cell of ``config`` and ``traffic`` on ``seed``
    for ``mode``: the program's (``program``) or its runner's stand-in."""
    from portbench import harness

    runner = harness.load_runner(traffic)
    if mode != "program":
        return runner.standin(config, traffic, seed, device, mode)
    c = runner.Cell(config, traffic, seed, device)
    c.window(seconds, {})
    c.release()
    return c.check()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", nargs="+", default=["program"])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    harness.require_cards(int(cell["cell"]["chips"]))
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for mode in args.mode:
            t0 = time.perf_counter()
            numbers = readings(cell["config"], cell["traffic"], seed, mode,
                               device, args.seconds)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
