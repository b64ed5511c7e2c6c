#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``ngx_torch``) once on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py``; it needs one
CUDA device and the CUDA toolkit (``nvcc``), and it exits non-zero, printing
no result, without them.  Phases, each fatal on failure:

1. the torch version, the card, and its power limit as ``nvidia-smi`` reads it;
2. build the acting kernel (``ngx_torch/ops/csrc/train_rollout.cu``) with nvcc;
3. the kernel against its plain twin on the card — Pogostick-v1 under
   LidarInFront, B = 8192 envs, T = 64 steps, hidden (64, 64), from the same
   state, weights and seed: per env everything bit-exact up to the env's first
   action mismatch, at most 1% of envs with a mismatch, and each mismatch at a
   near-tie of the Gumbel score;
4. the main path: ``make_train(PPOConfig(num_envs=8192))`` on ``cuda:0`` for
   3 PPO train steps, which must launch the kernel exactly 3 times and give
   finite losses;
5. rates: the kernel's and the twin's env-steps/s and the train step's.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

B, T, HIDDEN, CAP, SEED = 8192, 64, (64, 64), 100, 20261016
MAX_MISMATCH_SHARE = 0.01
GUMBEL_TIE_GAP = 1e-4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    # the port never imports JAX: make any such import fail loudly
    for mod in ("jax", "flax", "optax"):
        sys.modules[mod] = None
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ngx_torch as nt
    from ngx_torch.ops import _build
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams
    from ngx_torch.rl.models import ActorCritic
    from ngx_torch.rl.train import PPOConfig, make_train, pick_trainer_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {card}")
    print(smi)

    # ---- 2. build ---------------------------------------------------------
    path, secs, log = _build.build()
    print(f"[2] built {os.path.relpath(path)} in {secs:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # ---- 3. kernel vs plain twin -----------------------------------------
    spec = nt.lidar_in_front(nt.make_spec("NovelGridworld-Pogostick-v1"))
    block = pick_trainer_block(B)
    state = nt.counter_reset(spec, SEED, 0, B, device=dev)
    # spread the episode clocks so cap truncations and native resets fire
    # inside the 64 steps
    rng = np.random.RandomState(SEED % 2 ** 31)
    state = state.replace(step_count=torch.as_tensor(
        rng.randint(0, CAP, size=B), dtype=torch.int32, device=dev))
    gen = torch.Generator().manual_seed(SEED)
    obs_dim = int(nt.make_step(spec).get_obs(state).shape[1])
    model = ActorCritic(obs_dim, spec.n_actions, HIDDEN, generator=gen).to(dev)
    layers = [(w.detach(), b.detach()) for w, b in model.pi_layers()]

    out_k = TR.train_rollout(spec, state, layers, SEED, T, block=block,
                             cap=CAP)
    torch.cuda.synchronize()
    out_p = TR.train_rollout_plain(spec, state, layers, SEED, T, block=block,
                                   cap=CAP)
    torch.cuda.synchronize()
    first, bad = TR.compare_rollouts(out_k, out_p)
    if bad:
        fail(f"kernel and plain twin disagree inside the compared prefix: {bad}")
    mism = (first < T).nonzero()[:, 0]
    share = mism.numel() / B
    # every first mismatch must sit at a near-tie of the twin's Gumbel score
    seeds, rows = block_streams(SEED, B, block, dev)
    max_gap = 0.0
    for b in mism.tolist():
        t = int(first[b])
        logits = TR.mlp_logits(out_p[1][t, b][None], layers)
        score = TR.gumbel_scores(logits, seeds[b:b + 1], t + 1, rows[b:b + 1])
        top2 = torch.topk(score[0], 2).values
        max_gap = max(max_gap, float(top2[0] - top2[1]))
    steps = torch.arange(T, device=dev)[:, None]
    upto = steps <= first[None, :]
    err_obs = ((out_k[1] - out_p[1]).abs().amax(-1) * upto).amax()
    err_rew = ((out_k[3] - out_p[3]).abs() * (steps < first[None, :])).amax()
    max_abs_err = float(torch.maximum(err_obs, err_rew))
    n_done = int(out_k[4].sum())
    print(f"[3] kernel vs twin at B={B} T={T} block={block}: {n_done} dones "
          f"(native resets), {mism.numel()} envs with an action mismatch "
          f"({share:.5%}), top-2 Gumbel gap at a mismatch <= {max_gap:.3g}, "
          f"max |err| in the compared prefix {max_abs_err}")
    if n_done == 0:
        fail("no episode boundary inside the compared rollout")
    if share > MAX_MISMATCH_SHARE:
        fail(f"{share:.3%} of envs mismatch (limit {MAX_MISMATCH_SHARE:.0%})")
    if max_gap >= GUMBEL_TIE_GAP:
        fail(f"an action mismatch at a Gumbel gap of {max_gap} (not a tie)")

    # ---- 4. the main path: 3 PPO train steps through the kernel -----------
    cfg = PPOConfig(num_envs=B)
    init, train_step = make_train(cfg, device=dev)
    carry = init(SEED)
    count0 = carry[1].step_count.clone()
    torch.cuda.synchronize()
    TR.train_rollout.launches = 0
    step_s = []
    for u in range(3):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, SEED + u + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = TR.train_rollout.launches
    m = {k: float(v) for k, v in metrics.items()}
    print(f"[4] 3 train steps: launches={launches} "
          f"step seconds={['%.6f' % s for s in step_s]} metrics={m}")
    if launches != 3:
        fail(f"the acting kernel launched {launches} times in 3 train steps")
    for k in ("pg_loss", "v_loss", "entropy"):
        if not math.isfinite(m[k]):
            fail(f"{k} is not finite: {m[k]}")
    if torch.equal(carry[1].step_count, count0):
        fail("the carried step_count did not advance")
    if carry[2].shape != (B, obs_dim) or not torch.isfinite(carry[2]).all():
        fail("the carried obs has the wrong shape or is not finite")

    # ---- 5. rates ---------------------------------------------------------
    ev0, ev1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    reps = 10
    ev0.record()
    for _ in range(reps):
        TR.train_rollout(spec, state, layers, SEED, T, block=block, cap=CAP)
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / reps
    t0 = time.perf_counter()
    TR.train_rollout_plain(spec, state, layers, SEED, T, block=block, cap=CAP)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    train_s = sum(step_s[1:]) / len(step_s[1:])
    print(f"[5] {smi}: acting kernel {kernel_ms:.4f} ms = "
          f"{B * T / kernel_ms * 1e3:.1f} env-steps/s; plain twin "
          f"{plain_ms:.4f} ms = {B * T / plain_ms * 1e3:.1f} env-steps/s; "
          f"train step {train_s * 1e3:.4f} ms = {B * T / train_s:.1f} "
          f"env-steps/s (B={B}, T={T}, hidden {HIDDEN})")

    print(json.dumps({"kernels": [{
        "name": "train_rollout",
        "route": "cuda",
        "source": "ngx_torch/ops/csrc/train_rollout.cu",
        "replaces": "ngx/ops/pallas_rollout.py:812",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
