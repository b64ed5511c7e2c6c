"""Readings for the limits of ``correct`` in the cells of a configuration
with a ``novelty`` (the ``novelty_train`` and ``novelty_stepping``
runners): the numbers a cell compares, on many seeds, for the program and
for its stand-ins, as ``calibrate.py`` reads the other cells.

    python3 portbench/calibrate_novelty.py --workload <name> --seeds 1 2 3 \\
        --mode program control half alter unchanged pool [--seconds 2]

One JSON line per seed and mode on standard output: ``{"workload",
"seed", "mode", "numbers", "seconds"}``.  ``program`` runs the cell's
set-up and a short window (``--seconds``) and judges it as a run does.
``control`` puts the novelty reference in the program's place in the
precision below the configuration's: TF32 for the train cell, bfloat16
reward sums for stepping.  ``half``, ``alter``, ``unchanged`` and ``pool``
are the train cell's planted faults (half of every minibatch dropped, an
action altered, the parameters left unchanged, one pool row altered).
The benchmark's own runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    from portbench.reference import novelty
    from portbench.runners.stepping import schedule

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    harness.require_cards(int(cell["cell"]["chips"]))
    config, traffic = cell["config"], cell["traffic"]
    runner = harness.load_runner(traffic)
    device = torch.device("cuda", 0)
    train = traffic["runner"] == "novelty_train"
    for seed in args.seeds:
        for mode in args.mode:
            t0 = time.perf_counter()
            if mode == "program":
                c = runner.Cell(config, traffic, seed, device)
                if not train:
                    c.window(args.seconds, {})
                c.release()
                numbers = c.check()
                del c
            elif train:
                numbers = novelty.standin_train(
                    config, traffic, seed, device, tf32=mode == "control",
                    fault=None if mode == "control" else mode)
            else:
                seed_of, sampled = schedule(traffic, seed)
                numbers = novelty.standin_stepping(
                    config, traffic, [seed_of(i) for i in sampled], device,
                    torch.bfloat16)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
