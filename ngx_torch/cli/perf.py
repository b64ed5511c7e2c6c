"""Env-stepping and acting-loop rates — the port of ``ngx/cli/perf.py``.

    python -m ngx_torch.cli.perf -device cuda -batch 65536 -steps 1024
    python -m ngx_torch.cli.perf -device cuda --policy -batch 8192 -steps 256
    python -m ngx_torch.cli.perf -device cuda --trainer -batch 8192 -steps 64

The default mode times :func:`ngx_torch.vector.throughput_fn` (the
``'prng'`` rollout: the CUDA kernel on a CUDA device) and the kernel's plain
twin on the same device; ``-threads 32,64`` adds the kernel at those CUDA
threads per block; ``--no-twin`` leaves the twins out (they take seconds a
call at the larger batches).  ``--policy`` times the fused ``'policy'``
rollout kernel against its plain twin, the unfused acting loop.
``--trainer`` times one PPO train step of
:func:`ngx_torch.rl.train.make_train` at ``-steps`` rollout steps.  Every
time is the mean of ``-repeats`` back-to-back calls after one warm-up call,
by CUDA events on a CUDA device.  The last line is one JSON object with the
rates in env-steps/s, the times in ms, the device and the card's name.

On the CPU every mode runs the plain twins: those rates are CPU rates, never
the card's.  ngx's XLA-backend A/B and its throughput ablations
(``action_rng``, ``auto_reset``, ``packed``) are not ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _seconds(fn, device, repeats):
    """Mean seconds of ``repeats`` back-to-back calls of ``fn()`` after one
    warm-up call: by CUDA events on a CUDA device (the card's clock; one
    call's host work overlaps the previous call's kernel, as in a loop of
    calls), by the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(repeats):
        fn()
    ev1.record()
    torch.cuda.synchronize(device)
    return ev0.elapsed_time(ev1) / 1e3 / repeats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-batch", type=int, default=65536)
    p.add_argument("-steps", type=int, default=256)
    p.add_argument("-repeats", type=int, default=3)
    p.add_argument("-device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("--policy", action="store_true")
    p.add_argument("--trainer", action="store_true")
    p.add_argument("--no-twin", action="store_true",
                   help="default and policy modes: do not time the twin")
    p.add_argument("-block", type=int, default=256,
                   help="policy mode: the RNG block (ngx's default)")
    p.add_argument("-threads", default="",
                   help="default mode: also time the kernel at these CUDA "
                        "threads per block, e.g. 32,64,128,256")
    args = p.parse_args(argv)

    import ngx_torch as nt
    from ngx_torch.ops import rollout as R
    from ngx_torch.vector import throughput_fn

    from ngx_torch.ops.tables import resolve_device

    dev = resolve_device(args.device)
    B, S, seed = args.batch, args.steps, args.seed
    spec = nt.make_spec(args.env)
    rates, ms = {}, {}

    def timed(name, fn):
        t = _seconds(fn, dev, args.repeats)
        rates[name], ms[name] = B * S / t, t * 1e3
        print(f"{name:28s}: {B * S / t / 1e6:10.3f}M env-steps/s "
              f"({t * 1e3:.4f} ms)")

    if args.trainer:
        from ngx_torch.rl.train import PPOConfig, make_train

        cfg = PPOConfig(env_id=args.env, num_envs=B, rollout_steps=S)
        init, train_step = make_train(cfg, device=dev)
        carry = [init(seed)]

        def one_step():
            carry[0], _ = train_step(carry[0], seed + 1)

        timed("train_step", one_step)
    elif args.policy:
        from ngx_torch.rl.models import ActorCritic

        lspec = nt.lidar_in_front(spec)
        obs_dim = int(nt.make_step(lspec).get_obs(
            nt.counter_reset(lspec, seed, 0, 1)).shape[1])
        model = ActorCritic(obs_dim, lspec.n_actions, (64, 64),
                            generator=torch.Generator().manual_seed(seed))
        layers = [(w.detach().to(dev), b.detach().to(dev))
                  for w, b in model.pi_layers()]
        fused = R.make_rollout(lspec, B, S, block=args.block,
                               action_source="policy", pi_layers=layers,
                               device=dev)
        timed("policy_fused", lambda: fused(seed))
        if not args.no_twin:
            timed("policy_twin", lambda: R.rollout_plain(
                lspec, B, S, seed, args.block, "policy", pi_layers=layers,
                device=dev))
    else:
        run = throughput_fn(spec, B, S, device=dev)
        timed("throughput_fn", lambda: run(seed))
        block = 512 if B % 512 == 0 else B
        for n in [int(x) for x in args.threads.split(",") if x]:
            k = R.make_rollout(spec, B, S, block=block, device=dev,
                               threads=n)
            timed(f"prng_kernel_threads{n}", lambda: k(seed))
        if not args.no_twin:
            timed("prng_twin", lambda: R.rollout_plain(spec, B, S, seed,
                                                       block, device=dev))

    print(json.dumps({
        "env": args.env, "batch": B, "steps": S, "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "steps_per_s": rates, "ms": ms}))


if __name__ == "__main__":
    main()
