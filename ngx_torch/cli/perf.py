"""Env-stepping and acting-loop rates — the port of ``ngx/cli/perf.py``.

    python -m ngx_torch.cli.perf -batch 65536 -steps 1024       # ablations
    python -m ngx_torch.cli.perf --policy -batch 8192 -steps 256
    python -m ngx_torch.cli.perf --trainer -batch 8192 -steps 64 -novelty fence:medium:oak
    python -m ngx_torch.cli.perf --profile -profile_dir build/profile

The default mode is ngx's breakdown (``ngx/cli/perf.py:121-140``):
:func:`ngx_torch.vector.throughput_fn` (the ``'prng'`` rollout kernel on a
CUDA device) in ngx's five variants, each removing one suspected cost —
full (counter-RNG actions, auto-reset), ``'hash'`` actions, a fixed action,
no auto-reset, the final state bit-packed — so the deltas split a step
between the action draw, the env step and the reset.  Each is timed by CUDA
events over back-to-back calls (``ms``) and by the kernel's own device time
in ``torch.profiler``, or by CUDA events around each launch where the
profiler records none (``device_ms``: at T <= 64 a call's host work
outlasts the kernel).  ``-threads 32,64`` adds the full kernel at those CUDA threads
per block; the plain twin is timed unless ``--no-twin`` (it takes seconds a
call at the larger batches).  ``--profile`` writes a ``torch.profiler``
trace of one full call to ``-profile_dir`` (a directory ``.gitignore``
lists).  ``--policy`` times the fused ``'policy'`` rollout kernel against
its plain twin.  ``--trainer`` A/Bs one PPO train step of
:func:`ngx_torch.rl.train.make_train` at ``-steps`` rollout steps over the
acting backends, ``xla`` (the unfused loop) and ``pallas`` (the kernel),
on ``-env`` or, with ``-novelty kind:difficulty[:arg1[:arg2]]``, on the
injected spec; one more step of each is timed by phase.  Every time is the
mean of ``-repeats`` back-to-back calls after one warm-up call, by CUDA
events on a CUDA device.  The last line is one JSON object with the rates
in env-steps/s, the times in ms, the device and the card's name.

On the CPU every mode runs the plain twins: those rates are CPU rates, never
the card's, and ``device_ms`` is null.
"""

from __future__ import annotations

import argparse
import json
import os
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


# ngx's five variants, in ngx's order (ngx/cli/perf.py:127-135); ngx's
# full variant draws with threefry, the port's with the counter RNG
VARIANTS = (
    ("full", "full (counter actions, auto-reset)", {}),
    ("hash", "hash-rng actions", {"action_rng": "hash"}),
    ("fixed", "fixed action (no RNG)", {"action_rng": "fixed"}),
    ("no_auto_reset", "no auto-reset", {"auto_reset": False}),
    ("packed", "bit-packed final state", {"packed": True}),
)


def kernel_device_ms(fn, repeats):
    """``(ms, n, source)``: the mean device time of a launch of the rollout
    kernel (any of its variants, not the train kernel) over ``repeats``
    calls of ``fn`` after one warm-up call, the launches it averaged and
    how it was read.  First by ``torch.profiler`` (host and device
    activity; ``source`` 'profiler'), which on some machines records fewer
    launches than ran or none: a window that recorded none is profiled
    again, twice at most.  Then by a pair of CUDA events around each launch
    (``ops.rollout.launch.events``; ``source`` 'events'), which also counts
    the few microseconds between the start event and the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "rollout_kernel" in e.key
                  and "train_rollout" not in e.key]
        n = sum(e.count for e in events)
        us = sum(e.device_time_total for e in events)
        if n and us > 0:
            return us / n / 1e3, n, "profiler"
    ms, n = launch_event_ms(fn, repeats)
    return ms, n, "events"


def launch_event_ms(fn, repeats):
    """``(ms, n)``: the mean time between the CUDA events recorded around
    each rollout-kernel launch of ``repeats`` calls of ``fn``
    (``ops.rollout.launch.events``) and the launches timed; ``(None, 0)``
    when ``fn`` launched none."""
    from ngx_torch.ops import rollout as R

    R.launch.events = []
    try:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in R.launch.events]
    finally:
        R.launch.events = None
    if not times:
        return None, 0
    return sum(times) / len(times), len(times)


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
    p.add_argument("--trainer", action="store_true",
                   help="A/B one PPO train step over the xla and pallas "
                        "acting backends")
    p.add_argument("-novelty", default="",
                   help="trainer mode: inject this novelty first, e.g. "
                        "'firewall:easy' or 'fence:medium:oak'")
    p.add_argument("--profile", action="store_true",
                   help="default mode: write a torch.profiler trace of one "
                        "full call to -profile_dir")
    p.add_argument("-profile_dir", default="build/profile")
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
    rates, ms, dev_ms, phases = {}, {}, {}, {}

    def timed(name, fn, label=None):
        t = _seconds(fn, dev, args.repeats)
        rates[name], ms[name] = B * S / t, t * 1e3
        print(f"{label or name:38s}: {B * S / t / 1e6:10.3f}M env-steps/s "
              f"({t * 1e3:.4f} ms, {t * 1e9 / (B * S):.4f} ns/step)")

    if args.trainer:
        from ngx_torch.rl.train import PPOConfig, make_train

        spec_override = None
        if args.novelty:
            spec_override = nt.inject_novelty(spec, *args.novelty.split(":"))
            print(f"trainer spec: {args.env} + {args.novelty}")
        cfg = PPOConfig(env_id=args.env, num_envs=B, rollout_steps=S)
        for backend in ("xla", "pallas"):
            init, train_step = make_train(cfg, spec_override=spec_override,
                                          rollout_backend=backend,
                                          device=dev)
            carry = [init(seed)]
            step = [seed]

            def one_step():
                step[0] += 1
                carry[0], _ = train_step(carry[0], step[0])

            timed(f"train_step_{backend}", one_step,
                  f"train step [{backend:6s}]")
            train_step.phases = {}
            one_step()
            phases[backend] = {k: v[0] * 1e3
                               for k, v in train_step.phases.items()}
            print(f"  by phase, ms: {phases[backend]}")
    elif args.policy:
        from ngx_torch.rl.models import ActorCritic

        lspec = nt.lidar_in_front(spec)
        obs_dim = int(nt.make_step(lspec).get_obs(
            nt.counter_reset(lspec, seed, 0, 1, device="cpu")).shape[1])
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
        for key, label, kw in VARIANTS:
            run = throughput_fn(spec, B, S, device=dev, **kw)
            timed(key, lambda: run(seed), label)
            if dev.type == "cuda":
                dev_ms[key] = kernel_device_ms(lambda: run(seed),
                                               args.repeats)[0]
                print(f"{'':38s}  kernel device time {dev_ms[key]} ms")
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(args.profile_dir, exist_ok=True)
            run = throughput_fn(spec, B, S, device=dev)
            run(seed)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                run(seed)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            path = os.path.join(args.profile_dir, "throughput_fn.json")
            prof.export_chrome_trace(path)
            print("trace written to", path)
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
        "steps_per_s": rates, "ms": ms, "device_ms": dev_ms,
        "phases_ms": phases}))


if __name__ == "__main__":
    main()
