"""Scaling of the sharded train step — the port of ``ngx/rl/scaling.py``.

Two measurements over meshes of 1, 2, 4, ... ranks, one process per rank
(:func:`ngx_torch.parallel.spawn_ranks`):

* **fixed-total**: the same global batch split over more ranks; the
  throughput against the smallest mesh's isolates what the split and its
  collectives cost (the total work is constant).
* **weak**: a fixed batch per rank, so the total work grows with the mesh;
  the efficiency is the throughput per rank against the smallest mesh's.

On one card several ranks share it (gloo over CUDA tensors: pass
``backend='gloo'``), so the numbers there say what the split costs, not how
cards scale.  Nothing is asserted unless ``-assert_efficiency`` is given.

Run: ``python -m ngx_torch.rl.scaling -device cpu`` (gloo ranks on the CPU)
or ``-device cuda -backend gloo -devices 1,2`` (two ranks on one card).
"""

from __future__ import annotations

import time

import torch


def _scaling_rank(mesh, cfg_kwargs, repeats):
    """One rank: ``make_train(cfg, mesh)`` from ``key(0)``,
    a warm-up step on ``fold_in(key, 1)``, then ``repeats`` timed steps on
    ``fold_in(key, 2 + r)``: ngx's keys (``ngx/rl/scaling.py:56-64``).
    Each step ends in its metrics all-reduce, so rank 0's host clock reads
    the slowest rank.  Returns the shortest step's seconds and the acting
    kernel's launches in these steps (``train_rollout.launches``' form)."""
    from ..ops import threefry as TF
    from ..ops.train_rollout import train_rollout
    from .train import PPOConfig, make_train

    before = dict(train_rollout.launches)
    cfg = PPOConfig(**cfg_kwargs)
    init, train_step = make_train(cfg, mesh)
    key = TF.key(0)
    carry = init(key)
    carry, m = train_step(carry, TF.fold_in(key, 1))
    float(m["mean_reward"])
    times = []
    for r in range(repeats):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        carry, m = train_step(carry, TF.fold_in(key, 2 + r))
        float(m["mean_reward"])            # waits for the step
        times.append(time.perf_counter() - t0)
    return min(times), {k: n - before[k]
                        for k, n in train_rollout.launches.items()}


def measure_scaling(device_counts=(1, 2, 4, 8), per_device_batch: int = 256,
                    rollout_steps: int = 16, repeats: int = 3,
                    mode: str = "fixed-total", hidden=(64, 64),
                    env_id: str = "NovelGridworld-Pogostick-v1",
                    device="cuda", backend=None, timeout: float = 600.0):
    """Time the whole train step (rollout, GAE, PPO update) over meshes of
    ``device_counts`` ranks, each rank its own process on ``device``
    (the card by default; ``backend`` as :func:`ngx_torch.parallel.
    pick_backend`), acting through the trainer's default, the acting
    kernel on each rank's shard (ngx's harness acts through its unfused
    loop, which is its ``'auto'`` under a mesh).  Returns ngx's record: ``{"mode", "per_device_batch",
    "rollout_steps", "throughput": {n: env-steps/s}, "efficiency": {n:
    ratio}}``.  ``measure_scaling.launches`` then holds each mesh's
    acting-kernel launches, rank by rank: ``{n: [rank 0's, ...]}``."""
    from ..parallel import spawn_ranks

    if mode not in ("fixed-total", "weak"):
        raise ValueError(f"mode {mode!r} is not 'fixed-total' or 'weak'")
    total_fixed = per_device_batch * max(device_counts)
    out = {"mode": mode, "per_device_batch": per_device_batch,
           "rollout_steps": rollout_steps, "throughput": {}}
    measure_scaling.launches = {}
    for n in device_counts:
        B = total_fixed if mode == "fixed-total" else per_device_batch * n
        cfg = dict(env_id=env_id, num_envs=B, rollout_steps=rollout_steps,
                   hidden=tuple(hidden))
        ranks = spawn_ranks(_scaling_rank, n, (cfg, repeats), device=device,
                            backend=backend, timeout=timeout)
        out["throughput"][n] = B * rollout_steps / ranks[0][0]
        measure_scaling.launches[n] = [r[1] for r in ranks]
    base = out["throughput"][device_counts[0]]
    if mode == "fixed-total":
        out["efficiency"] = {n: out["throughput"][n] / base
                             for n in device_counts}
    else:
        out["efficiency"] = {n: (out["throughput"][n] / n) / base
                             for n in device_counts}
    return out


measure_scaling.launches = {}


def main(argv=None):
    import argparse
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("-devices", default="1,2,4,8",
                   help="mesh sizes, one process per rank")
    p.add_argument("-per_device_batch", type=int, default=256)
    p.add_argument("-rollout", type=int, default=16)
    p.add_argument("-repeats", type=int, default=3)
    p.add_argument("-mode", default="both",
                   choices=("fixed-total", "weak", "both"))
    p.add_argument("-device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("-backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU; two "
                        "ranks on one card need gloo")
    p.add_argument("-assert_efficiency", type=float, default=0.0,
                   help="exit nonzero if the largest mesh's fixed-total "
                        "efficiency falls below this")
    args = p.parse_args(argv)
    counts = tuple(int(x) for x in args.devices.split(","))
    worst = 1.0
    modes = ["fixed-total", "weak"] if args.mode == "both" else [args.mode]
    for mode in modes:
        r = measure_scaling(counts, args.per_device_batch, args.rollout,
                            args.repeats, mode=mode, device=args.device,
                            backend=args.backend)
        print(f"== {mode} scaling (per-device batch "
              f"{args.per_device_batch}, T={args.rollout}, {args.device}) ==")
        for n in counts:
            print(f"  {n} rank(s): {r['throughput'][n] / 1e6:.4f}M steps/s  "
                  f"efficiency {r['efficiency'][n]:.2%}")
        if mode == "fixed-total":
            worst = r["efficiency"][max(counts)]
    if args.assert_efficiency and worst < args.assert_efficiency:
        print(f"FAIL: fixed-total efficiency {worst:.2%} < "
              f"{args.assert_efficiency:.2%}")
        sys.exit(1)


if __name__ == "__main__":
    main()
