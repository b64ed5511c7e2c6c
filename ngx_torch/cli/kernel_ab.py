"""Time the acting kernels of several checkouts of the repo in one run.

    python -m ngx_torch.cli.kernel_ab PARENT_DIR CHANGE_DIR [-mode native|pool|policy]
    python -m ngx_torch.cli.kernel_ab . -mode pool -envs 16,32,64 -threads 16,32,64,128,256

Each directory is a checkout (a ``git archive`` of a commit, say) holding
its own ``ngx_torch``.  The checkouts run in turns — A, B, B, A, or each
in order and then in reverse for more — every one in a subprocess of its
own, which builds that checkout's kernels and times one kernel mode on one
card by CUDA events over ``-launches`` launches after one warm-up launch:

* ``native``: ``train_rollout`` with native resets on ``-env``
  (Pogostick-v1) under LidarInFront, ``-batch`` envs, ``-steps`` steps,
  ``-cap`` 100, the episode clocks spread over 0..99 so that resets fire;
* ``pool``: ``train_rollout`` with pool resets on fence medium
  (``inject_novelty(Pogostick-v1, "fence", "medium", "oak")``), R 4,
  ``-cap`` 10, the pool drawn by ``ops/rollout.py`` ``pool_reset``;
* ``policy``: ``rollout(..., "policy")`` at ``-steps`` (256 by default in
  this mode).

``-hidden`` (64, 64), weights from a seeded generator, the RNG block 256.
Beside each time the run prints a sha256 digest of every output (the
trajectory, the final state and ``base_out``), so two versions that should
agree bit for bit can be seen to.  ``-envs`` / ``-threads`` (comma lists)
time the tile kernels at each geometry with ``threads >= envs``, inside
one subprocess per checkout; they set the port's geometry constants, which
only a tree with the tile MLP reads.  Both versions then run on the same
card in one call, as two versions should be compared.  The last line is
one JSON object with each run's directory, geometry, milliseconds and
digest.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

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
mode, env, novelty, geos, hidden = sys.argv[1:6]
B, T, n, cap = map(int, sys.argv[6:10])
dev = torch.device("cuda:0")
spec = nt.make_spec(env)
if novelty:
    spec = nt.inject_novelty(spec, *novelty.split(","))
spec = nt.lidar_in_front(spec)
state = nt.counter_reset(spec, 7, 0, B, device=dev)
obs_dim = int(nt.make_step(spec).get_obs(state).shape[1])
model = ActorCritic(obs_dim, spec.n_actions,
                    tuple(int(h) for h in hidden.split(",")),
                    generator=torch.Generator().manual_seed(1)).to(dev)
layers = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
block = 256
if mode == "native":
    state = state.replace(step_count=torch.as_tensor(
        np.random.RandomState(3).randint(0, 100, B), dtype=torch.int32,
        device=dev))
    run = lambda: TR.train_rollout(spec, state, layers, 11, T, block=block,
                                   cap=cap)
elif mode == "pool":
    pool = R.pool_reset(spec, B * 4, 13, device=dev)
    base = torch.zeros(B, dtype=torch.int32, device=dev)
    run = lambda: TR.train_rollout(spec, state, layers, 11, T, block=block,
                                   cap=cap, pool=pool, base=base)
else:
    run = lambda: R.rollout(spec, B, T, 11, block, "policy",
                            pi_layers=layers, device=dev)


def digest(out):
    h = hashlib.sha256()
    for x in out:
        for t in ([getattr(x, k) for k in sorted(x.__dict__)]
                  if hasattr(x, "map") else [x]):
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


for geo in (geos.split(",") if geos else [""]):
    if geo:
        E, N = map(int, geo.split("x"))
        TR.ENVS, TR.THREADS = E, N
        R.POLICY_ENVS, R.THREADS["policy"] = E, N
    out = run()
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(n):
        run()
    ev1.record()
    torch.cuda.synchronize()
    print(json.dumps({"geometry": geo or None,
                      "ms": ev0.elapsed_time(ev1) / n,
                      "digest": digest(out)}))
"""

FENCE_MEDIUM = "fence,medium,oak"


def geometries(envs: str, threads: str) -> list:
    """``"ExN"`` for every pair of the two comma lists with ``N >= E``."""
    es = [int(x) for x in envs.split(",") if x]
    ns = [int(x) for x in threads.split(",") if x]
    return [f"{e}x{n}" for e in es for n in ns if n >= e]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+", help="checkouts, timed in turns")
    p.add_argument("-mode", choices=("native", "pool", "policy"),
                   default="native")
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-novelty", default=None,
                   help="inject_novelty arguments, comma-separated (pool "
                        f"mode: {FENCE_MEDIUM})")
    p.add_argument("-batch", type=int, default=8192)
    p.add_argument("-steps", type=int, default=None,
                   help="64, or 256 in policy mode")
    p.add_argument("-launches", type=int, default=10)
    p.add_argument("-cap", type=int, default=None,
                   help="the episode cap: 100 native, 10 pool")
    p.add_argument("-hidden", default="64,64", help="the policy's widths")
    p.add_argument("-envs", default="", help="tile envs, e.g. 16,32,64")
    p.add_argument("-threads", default="",
                   help="tile threads, e.g. 16,32,64,128,256")
    args = p.parse_args(argv)
    novelty = args.novelty
    if novelty is None:
        novelty = FENCE_MEDIUM if args.mode == "pool" else ""
    steps = args.steps or (256 if args.mode == "policy" else 64)
    cap = args.cap or (10 if args.mode == "pool" else 100)
    geos = ",".join(geometries(args.envs, args.threads)) \
        if args.envs and args.threads else ""
    order = list(args.dirs) + list(reversed(args.dirs))
    runs = []
    for d in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        proc = subprocess.run(
            [sys.executable, "-c", _TIMER, args.mode, args.env, novelty,
             geos, args.hidden, str(args.batch), str(steps),
             str(args.launches), str(cap)],
            cwd=d, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{d}: the timer failed:\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            runs.append({"dir": d, **r})
            print(f"{d}: {args.mode} {args.env} {novelty} B={args.batch} "
                  f"T={steps} geometry {r['geometry'] or 'default'}: "
                  f"{r['ms']:.4f} ms, sha256 {r['digest']}")
    print(json.dumps({"mode": args.mode, "env": args.env, "novelty": novelty,
                      "hidden": args.hidden, "batch": args.batch,
                      "steps": steps, "cap": cap, "runs": runs}))


if __name__ == "__main__":
    main()
