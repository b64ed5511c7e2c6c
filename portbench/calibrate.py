"""Readings for the limits of ``correct``: the numbers a cell compares, on
many seeds, for the program and for its stand-ins (the reference in a lower
precision, the control, and with a planted fault).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 \\
        --mode program control half alter unchanged [--seconds 12]

One JSON line per seed and mode on standard output: ``{"workload",
"seed", "mode", "numbers", "seconds"}``.  ``program`` runs the cell's
set-up and a short window (``--seconds``; the sampled calls of the
stepping and eval mixes come from it) and judges it as a run does.
``control`` puts the reference in the program's place in the precision
below the configuration's: TF32 for the train and eval mixes, bfloat16
reward sums for stepping.  ``half``, ``alter`` and ``unchanged`` are the
train mix's planted faults (half of every minibatch dropped, an action
altered where it is produced, the parameters left unchanged).  The
benchmark's own runs never run this."""

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
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.reference import checks

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    harness.require_cards(int(cell["cell"]["chips"]))
    config, traffic = cell["config"], cell["traffic"]
    runner = harness.load_runner(traffic)
    device = torch.device("cuda", 0)
    kind = traffic["runner"]
    for seed in args.seeds:
        for mode in args.mode:
            t0 = time.perf_counter()
            if mode == "program":
                c = runner.Cell(config, traffic, seed, device)
                if kind != "train":
                    c.window(args.seconds, {})
                c.release()
                numbers = c.check()
                del c
            elif kind == "train":
                numbers = checks.standin_train(
                    config, traffic, seed, device,
                    tf32=mode == "control",
                    fault=None if mode == "control" else mode,
                    root=str(ROOT))
            elif kind == "stepping":
                seed_of, sampled = runner.schedule(traffic, seed)
                seeds = [seed_of(i) for i in sampled]
                numbers = checks.standin_stepping(config, traffic, seeds,
                                                  device, torch.bfloat16)
            else:
                _, sampled = runner.schedule(traffic, seed)
                numbers = checks.standin_eval(
                    config, traffic,
                    [(int(traffic["pool_seed"]), j + 1) for j in sampled],
                    device, root=str(ROOT))
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
