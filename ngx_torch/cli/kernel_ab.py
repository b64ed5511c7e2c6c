"""Time the train-rollout kernel of several checkouts of the repo in one run.

    python -m ngx_torch.cli.kernel_ab PARENT_DIR CHANGE_DIR [-env ID] [-novelty NAME,DIFFICULTY,ARG]

Each directory is a checkout (a ``git archive`` of a commit, say) holding
its own ``ngx_torch``.  The checkouts run in turns — A, B, B, A, or each
in order and then in reverse for more — every one in a subprocess of its
own, which builds that checkout's kernels and times ``train_rollout`` on
one card: native resets, ``-batch`` envs, ``-steps`` steps, hidden (64,
64), the RNG block ngx's trainer picks, cap 100, by CUDA events over
``-launches`` launches after one warm-up launch.  Both versions then run
on the same card in one call, as two versions should be compared.  The
last line is one JSON object with each run's directory and milliseconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# runs inside each checkout; it uses only the API every slice of the port
# has had: counter_reset, make_step, ActorCritic and train_rollout
_TIMER = r"""
import json, sys
import torch
import ngx_torch as nt
from ngx_torch.ops.train_rollout import train_rollout
from ngx_torch.rl.models import ActorCritic
env, novelty, B, T, n = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6])
dev = torch.device("cuda:0")
spec = nt.make_spec(env)
if novelty:
    spec = nt.inject_novelty(spec, *novelty.split(","))
spec = nt.lidar_in_front(spec)
state = nt.counter_reset(spec, 7, 0, B, device=dev)
obs_dim = int(nt.make_step(spec).get_obs(state).shape[1])
model = ActorCritic(obs_dim, spec.n_actions, (64, 64),
                    generator=torch.Generator().manual_seed(1)).to(dev)
layers = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
block = 256 if B % 256 == 0 else 128
run = lambda: train_rollout(spec, state, layers, 11, T, block=block, cap=100)
run()
ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
ev0.record()
for _ in range(n):
    run()
ev1.record()
torch.cuda.synchronize()
print(json.dumps({"ms": ev0.elapsed_time(ev1) / n}))
"""


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+", help="checkouts, timed in turns")
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-novelty", default="",
                   help="inject_novelty arguments, comma-separated")
    p.add_argument("-batch", type=int, default=8192)
    p.add_argument("-steps", type=int, default=64)
    p.add_argument("-launches", type=int, default=10)
    args = p.parse_args(argv)
    order = list(args.dirs) + list(reversed(args.dirs))
    runs = []
    for d in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        proc = subprocess.run(
            [sys.executable, "-c", _TIMER, args.env, args.novelty,
             str(args.batch), str(args.steps), str(args.launches)],
            cwd=d, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{d}: the timer failed:\n{proc.stderr}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])["ms"]
        runs.append({"dir": d, "ms": ms})
        print(f"{d}: train_rollout {args.env} {args.novelty} B={args.batch} "
              f"T={args.steps}: {ms:.4f} ms")
    print(json.dumps({"env": args.env, "novelty": args.novelty,
                      "batch": args.batch, "steps": args.steps,
                      "runs": runs}))


if __name__ == "__main__":
    main()
