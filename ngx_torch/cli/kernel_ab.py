"""Time the kernels of several checkouts of the repo in one run.

    python -m ngx_torch.cli.kernel_ab PARENT_DIR CHANGE_DIR [-mode MODE]
    python -m ngx_torch.cli.kernel_ab . -mode pool -envs 16,32,64 -threads 16,32,64,128,256
    python -m ngx_torch.cli.kernel_ab . -mode prng -steps 1024 -threads 32,64,128,256 -lanes 1,4
    python -m ngx_torch.cli.kernel_ab PARENT_DIR CHANGE_DIR -mode sass

Each directory is a checkout (a ``git archive`` of a commit, say) holding
its own ``ngx_torch``.  The checkouts run in turns — A, B, B, A, or each
in order and then in reverse for more — every one in a subprocess of its
own, which builds that checkout's kernels and times one kernel mode on one
card over ``-launches`` launches after one warm-up launch, by CUDA events
(``ms``, the call's rate) and by ``torch.profiler`` (``device_ms``, the
kernel's own time, which at short T the call's host work hides):

* ``native``: ``train_rollout`` with native resets on ``-env``
  (Pogostick-v1) under LidarInFront, ``-batch`` envs, ``-steps`` steps,
  ``-cap`` 100, the episode clocks spread over 0..99 so that resets fire;
* ``pool``: ``train_rollout`` with pool resets on fence medium
  (``inject_novelty(Pogostick-v1, "fence", "medium", "oak")``), R 4,
  ``-cap`` 10, the pool drawn by ``ops/rollout.py`` ``pool_reset``;
* ``policy``: ``rollout(..., "policy")`` at ``-steps`` (256 by default in
  this mode);
* ``prng``: ``rollout(..., "prng")`` on ``-env`` (random actions and
  auto-resets, ``throughput_fn``'s kernel), RNG block 512;
* ``input``: ``rollout(..., "input")`` on ``-env``, the actions an int32
  ``[T, B]`` stream from ``numpy.random``, RNG block 512;
* ``draw``: the trainer's pool draw on fence medium, ``pool_reset`` of
  ``-batch`` envs (32,768 by default: B 8,192 × R 4) at T 0 in one RNG
  block.

``-batch`` may be a comma list, timed in turn inside each subprocess.

``-mode sass`` times nothing: it builds each checkout's library and prints,
for every kernel in it, ptxas's registers and spills and the SASS
instruction and ``BSSY`` counts (``ngx_torch.ops._build.sass_counts``), so
that two versions' code can be compared.

The tile modes run ``-hidden`` (64, 64), weights from a seeded generator,
the RNG block 256.  Beside each time the run prints a sha256 digest of
every output (the trajectory, the final state, ``base_out``, the reward
sums and done counts), so two versions that should agree bit for bit can
be seen to.  ``-envs`` / ``-threads`` (comma lists) time the tile kernels
at each geometry with ``threads >= envs``; in ``prng``, ``input`` and
``draw`` ``-threads`` / ``-lanes`` time each thread count a block and
fewest lanes a reset (``ops/rollout.py`` ``THREADS``, ``RESET_LANES``),
inside one subprocess per checkout.  They set the port's geometry
constants, which a tree reads only where it has them.  Both versions then
run on the same card in one call, as two versions should be compared.  The
last line is one JSON object with each run's directory, geometry,
milliseconds and digest.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# runs inside each checkout; it uses only the API every slice of the port
# since PR 3 has had: counter_reset, inject_novelty, make_step, ActorCritic,
# train_rollout, rollout and pool_reset
_TIMER = r"""
import hashlib, json, sys
import numpy as np
import torch
import ngx_torch as nt
from ngx_torch.ops import rollout as R
from ngx_torch.ops import train_rollout as TR
from ngx_torch.rl.models import ActorCritic
mode, env, novelty, geos, hidden, batches = sys.argv[1:7]
T, n, cap = map(int, sys.argv[7:10])
dev = torch.device("cuda:0")
spec = nt.make_spec(env)
if novelty:
    spec = nt.inject_novelty(spec, *novelty.split(","))
if mode in ("native", "pool", "policy"):
    spec = nt.lidar_in_front(spec)
block = 256


def make_run(B):
    if mode in ("native", "pool", "policy"):
        state = nt.counter_reset(spec, 7, 0, B, device=dev)
        obs_dim = int(nt.make_step(spec).get_obs(state).shape[1])
        model = ActorCritic(obs_dim, spec.n_actions,
                            tuple(int(h) for h in hidden.split(",")),
                            generator=torch.Generator().manual_seed(1)).to(dev)
        layers = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
    if mode == "native":
        state = state.replace(step_count=torch.as_tensor(
            np.random.RandomState(3).randint(0, 100, B), dtype=torch.int32,
            device=dev))
        return lambda: TR.train_rollout(spec, state, layers, 11, T,
                                        block=block, cap=cap)
    if mode == "pool":
        pool = R.pool_reset(spec, B * 4, 13, device=dev)
        base = torch.zeros(B, dtype=torch.int32, device=dev)
        return lambda: TR.train_rollout(spec, state, layers, 11, T,
                                        block=block, cap=cap, pool=pool,
                                        base=base)
    if mode == "policy":
        return lambda: R.rollout(spec, B, T, 11, block, "policy",
                                 pi_layers=layers, device=dev)
    if mode == "prng":
        return lambda: R.rollout(spec, B, T, 11, 512, "prng", device=dev)
    if mode == "input":
        acts = torch.as_tensor(np.random.RandomState(3).randint(
            spec.n_actions, size=(T, B)), dtype=torch.int32, device=dev)
        return lambda: R.rollout(spec, B, T, 11, 512, "input", actions=acts,
                                 device=dev)
    return lambda: R.pool_reset(spec, B, 13, device=dev)


def digest(out):
    h = hashlib.sha256()
    for x in (out if isinstance(out, tuple) else (out,)):
        for t in ([getattr(x, k) for k in sorted(x.__dict__)]
                  if hasattr(x, "map") else [x]):
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def device_ms(run):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "rollout_kernel" in e.key)
    return us / n / 1e3


for B in map(int, batches.split(",")):
    run = make_run(B)
    for geo in (geos.split(",") if geos else [""]):
        if geo and mode in ("native", "pool", "policy"):
            E, N = map(int, geo.split("x"))
            TR.ENVS, TR.THREADS = E, N
            R.POLICY_ENVS, R.THREADS["policy"] = E, N
        elif geo:
            N, lanes = map(int, geo.split("x"))
            R.THREADS["prng"] = R.THREADS["input"] = N
            R.RESET_LANES = lanes
        out = run()
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(n):
            run()
        ev1.record()
        torch.cuda.synchronize()
        print(json.dumps({"batch": B, "geometry": geo or None,
                          "ms": ev0.elapsed_time(ev1) / n,
                          "device_ms": device_ms(run),
                          "digest": digest(out)}))
"""

FENCE_MEDIUM = "fence,medium,oak"

# runs inside each checkout: build its library (in its own build/), print
# the path and the compiler's log
_BUILD = r"""
import json
from ngx_torch.ops import _build
path, secs, log = _build.build()
print(json.dumps({"lib": str(path), "seconds": secs, "log": log}))
"""


def ptxas_lines(log: str) -> dict:
    """``{mangled kernel: [ptxas lines]}``: the registers and spills lines
    ``-Xptxas -v`` printed after each kernel's entry."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.strip())
    return out


def sass_report(dirs) -> list:
    """Each checkout's kernels: ptxas lines, SASS and BSSY counts."""
    from ngx_torch.ops._build import demangle, sass_counts

    rows = []
    for d in dirs:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        proc = subprocess.run([sys.executable, "-c", _BUILD], cwd=d, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{d}: the build failed:\n{proc.stderr}")
        built = json.loads(proc.stdout.strip().splitlines()[-1])
        ptxas = ptxas_lines(built["log"])
        counts = sass_counts(Path(built["lib"]))
        for name, (mangled, (n, bssy)) in zip(demangle(counts),
                                              counts.items()):
            rows.append({"dir": d, "kernel": name, "sass": n, "bssy": bssy,
                         "ptxas": ptxas.get(mangled, [])})
            print(f"{d}: {name}: {n} SASS instructions, {bssy} BSSY; "
                  f"{'; '.join(ptxas.get(mangled, []))}")
    return rows


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def geometries(envs: str, threads: str) -> list:
    """``"ExN"`` for every pair of the two comma lists with ``N >= E``: the
    tile modes' envs and threads."""
    return [f"{e}x{n}" for e in _ints(envs) for n in _ints(threads)
            if n >= e]


def rollout_geometries(threads: str, lanes: str) -> list:
    """``"NxL"`` for every pair of the two comma lists: the rollout modes'
    threads a block and fewest lanes a reset (1 where none is given)."""
    return [f"{n}x{g}" for n in _ints(threads) for g in _ints(lanes or "1")]


ROLLOUT_MODES = ("prng", "input", "draw")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+", help="checkouts, timed in turns")
    p.add_argument("-mode", choices=("native", "pool", "policy")
                   + ROLLOUT_MODES + ("sass",), default="native")
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-novelty", default=None,
                   help="inject_novelty arguments, comma-separated (pool "
                        f"and draw modes: {FENCE_MEDIUM})")
    p.add_argument("-batch", default=None,
                   help="envs, a comma list: 8192, or 32768 in draw mode")
    p.add_argument("-steps", type=int, default=None,
                   help="64, 256 in policy mode, 0 in draw mode")
    p.add_argument("-launches", type=int, default=10)
    p.add_argument("-cap", type=int, default=None,
                   help="the episode cap: 100 native, 10 pool")
    p.add_argument("-hidden", default="64,64", help="the policy's widths")
    p.add_argument("-envs", default="", help="tile envs, e.g. 16,32,64")
    p.add_argument("-threads", default="",
                   help="threads a block, e.g. 16,32,64,128,256")
    p.add_argument("-lanes", default="",
                   help="rollout modes: the fewest lanes a reset, e.g. 1,4")
    args = p.parse_args(argv)
    if args.mode == "sass":
        print(json.dumps({"mode": "sass", "kernels": sass_report(args.dirs)}))
        return
    novelty = args.novelty
    if novelty is None:
        novelty = FENCE_MEDIUM if args.mode in ("pool", "draw") else ""
    steps = args.steps if args.steps is not None else (
        {"policy": 256, "draw": 0}.get(args.mode, 64))
    batch = args.batch or ("32768" if args.mode == "draw" else "8192")
    cap = args.cap or (10 if args.mode == "pool" else 100)
    if args.mode in ROLLOUT_MODES:
        geos = ",".join(rollout_geometries(args.threads, args.lanes)) \
            if args.threads else ""
    else:
        geos = ",".join(geometries(args.envs, args.threads)) \
            if args.envs and args.threads else ""
    order = list(args.dirs) + list(reversed(args.dirs))
    runs = []
    for d in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        proc = subprocess.run(
            [sys.executable, "-c", _TIMER, args.mode, args.env, novelty,
             geos, args.hidden, batch, str(steps), str(args.launches),
             str(cap)],
            cwd=d, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{d}: the timer failed:\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            runs.append({"dir": d, **r})
            print(f"{d}: {args.mode} {args.env} {novelty} B={r['batch']} "
                  f"T={steps} geometry {r['geometry'] or 'default'}: "
                  f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
                  f"sha256 {r['digest']}")
    print(json.dumps({"mode": args.mode, "env": args.env, "novelty": novelty,
                      "hidden": args.hidden, "batch": batch,
                      "steps": steps, "cap": cap, "runs": runs}))


if __name__ == "__main__":
    main()
