#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``ngx_torch``) once on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py``; it needs one
CUDA device and the CUDA toolkit (``nvcc``), and it exits non-zero, printing
no result, without them.  Phases, each fatal on failure:

1. the torch version, the card, and its power limit as ``nvidia-smi`` reads it;
2. build both kernels (``ngx_torch/ops/csrc/train_rollout.cu`` and
   ``rollout.cu``, one nvcc each, started together);
3. the acting kernel against its plain twin on the card — Pogostick-v1 under
   LidarInFront, B = 8192 envs, T = 64 steps, hidden (64, 64), from the same
   state, weights and seed: per env everything bit-exact up to the env's first
   action mismatch, at most 1% of envs with a mismatch, and each mismatch at a
   near-tie of the Gumbel score;
4. the main path: ``make_train(PPOConfig(num_envs=8192))`` on ``cuda:0`` for
   3 PPO train steps, which must launch the kernel exactly 3 times and give
   finite losses;
5. rates: the kernel's and the twin's env-steps/s and the train step's.

Then the env-stepping slice (``ngx_torch/ops/rollout.py``):

a. the rollout kernel's registers and spills as ptxas reports them;
b. 'input' and 'prng' modes at B = 8192, T = 64, block 512 against the plain
   twin: Pogostick-v1 in both modes (actions from ``numpy.random``), 'input'
   on NovelGridworld-v5, v3 and Pogostick-v0, 'prng' on v2 and v4.  Every
   state field and each env's reward sum bit for bit, the done counts
   exactly, episode ends in the v2, v3 and v4 runs.  The main paths —
   ``throughput_fn`` ('prng') and ``make_rollout(..., 'input')`` — run with
   the launch counts set to 0 just before and read just after;
c. 'policy' mode at B = 8192, T = 64, hidden (64, 64), block 256: bit-exact
   against the train-rollout kernel from the same ctr-0 start with the cap
   off (2^30), its reward sums equal to a step-by-step sum of the emitted
   rewards; against its plain twin at most 1% of envs differ; the main path
   ``make_rollout(..., 'policy')`` counted as in (b);
d. the phase-3 check on ``lidar_in_front(NovelGridworld-v5)``, B = 8192,
   T = 64;
e. rates over at least 3 launches: ``throughput_fn`` at B = 8192, 65536
   and 262144, T = 1024, by CUDA events; the 'prng' and 'input' kernels
   against their twins at B = 8192, T = 64 and the policy kernel against
   its twin at B = 8192, T = 256, each kernel by its device time in
   ``torch.profiler`` (at T = 64 a call's host work outlasts the kernel, so
   events would time the host).

Then training under novelty (fence medium is ``inject_novelty(
Pogostick-v1, "fence", "medium", "oak")`` under LidarInFront):

f. the train kernel's pool mode on fence medium, B = 8192, T = 64, hidden
   (64, 64), R = 4, cap 10 (every env restores at least 6 times, so the
   slots cycle), against its twin from the same state, weights, seed and
   pool, as in phase 3, ``base_out`` included; the pool, drawn on the card
   by the rollout kernel at T = 0 in one RNG block of B*R envs, equal to
   ``reset_rows`` run on the card;
g. the main path: ``make_train(PPOConfig(num_envs=8192),
   spec_override=fence medium)`` for 3 train steps, which must launch the
   pool-mode kernel exactly 3 times and draw 3 pools, with finite losses
   and episodes; one step on ``NovelGridworld-Pogostick-v0`` takes the pool
   too (ngx's rule: its reset places a tap);
h. the novelty step and reset edits on the card: 'input' mode bit-exact
   against the twin on the 13 novelty specs and a stacked one, 'prng' on
   firewall hard and fence hard, B = 8192, T = 64; phase 3's check on the
   native train kernel on fence easy;
i. rates: pool mode against native mode on fence medium (CUDA events over
   10 launches, in turns), the pool generator's device time
   (``torch.profiler``), the novelty train step by phase, and ptxas's
   registers and spills of both kernels;
j. the tile MLP (the train kernel and 'policy': a block of threads runs the
   MLP of a tile of envs): the train kernel's novelty instantiation on
   Pogostick-v1 equal to the plain one bit for bit, both timed in turns
   (CUDA events over 10 launches); each tile kernel's ptxas registers and
   spills and its block's shared-memory bytes; the times of the train
   kernel's two modes and of 'policy'.

Then the warp redesign of 'prng' and 'input' (a warp steps 32 envs and
resets the envs a step finished together, ``csrc/ngx_env.cuh`` warp_reset):

k. bit for bit against the twin at B = 8192, T = 64 on reset-heavy specs —
   'prng' on v3, firewall hard and firewall hard stacked with fence easy
   (two reset edits at every boundary), 'input' on v2, and 'prng' on v3 at
   B = 8100 in blocks of 450 (a ragged last warp); ptxas's registers and
   spills of ``rollout_kernel<false>`` and ``<true>`` and a block's dynamic
   shared memory; ``throughput_fn``'s device time at B = 8192, 65536 and
   262144, T = 1024, and the pool draw's (phase i).

Then the curriculum chain (``ngx_torch/rl/curriculum.py``: the reference's
restore-chaining sweep NovelGridworld-v2 -> v3 -> v4 -> v5, the stage agents
from ``trained_agents_torch/chain``):

l. the train kernel's pool mode against its twin on the chain pool: B =
   8192, T = 64, hidden (64, 64), R = 4, cap 100 from the init's nonzero
   base, chain_solver_v5's policy, ``base_out`` included; the pool's largest
   inventory; the chain's stage-0 draw (``pool_reset``, the rollout kernel
   at T = 0, 1024 rows of NovelGridworld-v2) against ``reset_rows`` on the
   card, each with its own row in the kernels' record;
m. the main path: ``make_train_chain(PPOConfig(env_id="NovelGridworld-v5",
   num_envs=8192, solve_shaped=True, bc_coef=0.05), ...)`` with the v5
   demos as the BC anchor: init, one ``refresh_pool``, 3 train steps, which
   must launch the pool-mode kernel exactly 3 times and draw stage 0 by
   ``pool_reset`` exactly twice, with finite losses and at least B episodes
   over the three steps (the init's base is each env's step count, so no
   env meets the cap of 100 inside the first 64 steps); each step by phase;
n. evaluation at 1024 episodes, each metric held to a range around the JAX
   reference's own numbers: ``evaluate_chain`` with chain_solver_v5 and with
   the v5 farming agent, ``evaluate_checkpoint`` on the Pogostick-v1 solver
   (trained and random), and ``make_eval``'s time;
o. the training CLI in a subprocess: a 3-update chain run with the BC
   anchor, a 1-update ``-resume`` of it, its monitor CSV, and
   ``evaluate_chain`` on the ``final.pt`` it saved.

The line before the last is the kernels' JSON record: per kernel its
launches on a main path (``paths`` has the count on each main path that
runs it), its error against the plain version, its time, the plain
version's, and ``bound_ms``, the larger of the bytes it must move over 3.35
TB/s and its float32 operations over 67 TFLOP/s (the H100 SXM's data-sheet
peaks; the env step's integer work is not counted); no PyTorch call
computes any of them, so ``library_ms`` is null.  The last line is
``{"ok": true, "device": {...}}``.
"""

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time

B, T, HIDDEN, CAP, SEED = 8192, 64, (64, 64), 100, 20261016
POGO = "NovelGridworld-Pogostick-v1"
POOL_R, POOL_CAP = 4, 10
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12      # H100 SXM data sheet
# the 13 novelties, one case each, and two stacked (phase h)
NOVELTIES = (
    (POGO, (("addchop",),)), (POGO, (("additem", "easy", "fence"),)),
    (POGO, (("addjump",),)), (POGO, (("axe", "easy", "wooden"),)),
    (POGO, (("axetobreak", "hard", "iron"),)),
    (POGO, (("breakincrease", "hard", "tree_log"),)),
    (POGO, (("crate", "medium"),)),
    ("NovelGridworld-Bow-v1", (("extractincdec", "hard", "decrease"),)),
    (POGO, (("fence", "easy", "oak"),)),
    (POGO, (("fencerestriction", "medium", "oak"),)),
    (POGO, (("firewall", "easy"),)), (POGO, (("remapaction", "easy"),)),
    ("NovelGridworld-Bow-v0", (("replaceitem", "easy", "wall", "stone"),)),
    (POGO, (("axe", "medium", "wooden"), ("fence", "easy", "oak"))),
)
MAX_MISMATCH_SHARE = 0.01
GUMBEL_TIE_GAP = 1e-4
ROLLOUT_BLOCK, POLICY_BLOCK = 512, 256
RAGGED_B, RAGGED_BLOCK = 8100, 450      # phase k: a ragged last warp
RATE_BATCHES, RATE_T, POLICY_RATE_T = (8192, 65536, 262144), 1024, 256
REPS = 3
# phases l-o: the curriculum chain (reference tests/train_last_agent.py)
CHAIN = ("NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5")
EVAL_EPISODES = 1024


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
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.ops import _build
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams
    from ngx_torch.ops.tables import c_ints, has_novelty, kernel_tables
    from ngx_torch.rl.bc import load_demos
    from ngx_torch.rl.curriculum import evaluate_chain, make_train_chain
    from ngx_torch.rl.evaluate import evaluate_checkpoint, make_eval
    from ngx_torch.rl.models import ActorCritic
    from ngx_torch.rl.train import PPOConfig, make_train, pick_trainer_block
    from ngx_torch.utils.checkpoint import restore_checkpoint
    from ngx_torch.vector import throughput_fn

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

    def sync_ms(fn):
        """Host clock around one call that ends in a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def event_ms(fn, reps=REPS):
        """Mean ms of ``reps`` back-to-back calls on the card's clock, after
        one warm-up call."""
        fn()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    def device_ms(fn, reps=REPS):
        """Mean device time of the rollout kernel per launch, by
        torch.profiler over ``reps`` calls of ``fn`` (one launch each) after
        one warm-up call; the mean is over the launches the profiler
        recorded, which can be fewer than ``reps``."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "rollout_kernel" in e.key
                  and "train_rollout" not in e.key]
        us = sum(e.device_time_total for e in events)
        n = sum(e.count for e in events)
        if us <= 0 or n < 1:
            fail("torch.profiler recorded no device time for rollout_kernel")
        if n != reps:
            print(f"[profiler] recorded {n} of {reps} rollout_kernel launches")
        return us / n / 1e3

    def obs_dim_of(spec):
        state = nt.counter_reset(spec, SEED, 0, 1, device=dev)
        return int(nt.make_step(spec).get_obs(state).shape[1])

    def check_bounds(what, metrics, bounds):
        """Fail unless each ``(key, lo, hi)`` has lo <= metrics[key] <= hi."""
        for key, lo, hi in bounds:
            if not lo <= metrics[key] <= hi:
                fail(f"{what}: {key} {metrics[key]} outside [{lo}, {hi}]")

    def policy_layers(spec, hidden, seed):
        state = nt.counter_reset(spec, seed, 0, 1, device=dev)
        obs_dim = int(nt.make_step(spec).get_obs(state).shape[1])
        gen = torch.Generator().manual_seed(seed)
        model = ActorCritic(obs_dim, spec.n_actions, hidden,
                            generator=gen).to(dev)
        return [(w.detach(), b.detach()) for w, b in model.pi_layers()]

    # ---- 2. build ---------------------------------------------------------
    path, secs, log = _build.build()
    print(f"[2] built {os.path.relpath(path)} from "
          f"{' + '.join(_build.SOURCES)} (one nvcc each, in parallel), "
          f"{secs:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # ---- 3. kernel vs plain twin -----------------------------------------
    def check_train_kernel(tag, spec, block, cap=CAP, pool=None, start=None,
                           base=None, layers=None):
        """The train kernel against its twin (native mode, or pool mode
        with ``pool`` and ``base``, zeros by default); returns the start
        state, the weights, the max |err| in the compared prefix, the
        kernel's outputs and the twin's ms.  ``start``: the start state
        (by default a counter reset with spread episode clocks);
        ``layers``: the policy tower (by default random, from SEED)."""
        state = start
        if state is None:
            state = nt.counter_reset(spec, SEED, 0, B, device=dev)
            # spread the episode clocks so cap truncations and resets fire
            # inside the 64 steps
            rng = np.random.RandomState(SEED % 2 ** 31)
            state = state.replace(step_count=torch.as_tensor(
                rng.randint(0, cap, size=B), dtype=torch.int32, device=dev))
        if layers is None:
            layers = policy_layers(spec, HIDDEN, SEED)
        kw = dict(block=block, cap=cap)
        if pool is not None:
            kw.update(pool=pool, base=base if base is not None else
                      torch.zeros(B, dtype=torch.int32, device=dev))
        out_k = TR.train_rollout(spec, state, layers, SEED, T, **kw)
        torch.cuda.synchronize()
        out_p, p_ms = sync_ms(lambda: TR.train_rollout_plain(
            spec, state, layers, SEED, T, **kw))
        first, bad = TR.compare_rollouts(out_k, out_p)
        if bad:
            fail(f"{tag}: kernel and plain twin disagree inside the compared "
                 f"prefix: {bad}")
        mism = (first < T).nonzero()[:, 0]
        share = mism.numel() / B
        # every first mismatch must sit at a near-tie of the twin's Gumbel
        # score
        seeds, rows = block_streams(SEED, B, block, dev)
        max_gap = 0.0
        for b in mism.tolist():
            t = int(first[b])
            logits = TR.mlp_logits(out_p[1][t, b][None], layers)
            score = TR.gumbel_scores(logits, seeds[b:b + 1], t + 1,
                                     rows[b:b + 1])
            top2 = torch.topk(score[0], 2).values
            max_gap = max(max_gap, float(top2[0] - top2[1]))
        steps = torch.arange(T, device=dev)[:, None]
        upto = steps <= first[None, :]
        err_obs = ((out_k[1] - out_p[1]).abs().amax(-1) * upto).amax()
        err_rew = ((out_k[3] - out_p[3]).abs()
                   * (steps < first[None, :])).amax()
        max_abs_err = float(torch.maximum(err_obs, err_rew))
        n_done = int(out_k[4].sum())
        mode = "pool restores" if pool is not None else "native resets"
        print(f"{tag} kernel vs twin on {spec.env_id} {spec.novelty_tag} "
              f"at B={B} T={T} block={block} cap={cap}: {n_done} dones "
              f"({mode}), "
              f"{mism.numel()} envs with an action mismatch ({share:.5%}), "
              f"top-2 Gumbel gap at a mismatch <= {max_gap:.3g}, "
              f"max |err| in the compared prefix {max_abs_err}")
        if n_done == 0:
            fail(f"{tag}: no episode boundary inside the compared rollout")
        if share > MAX_MISMATCH_SHARE:
            fail(f"{tag}: {share:.3%} of envs mismatch "
                 f"(limit {MAX_MISMATCH_SHARE:.0%})")
        if max_gap >= GUMBEL_TIE_GAP:
            fail(f"{tag}: an action mismatch at a Gumbel gap of {max_gap} "
                 "(not a tie)")
        return state, layers, max_abs_err, out_k, p_ms

    spec = nt.lidar_in_front(nt.make_spec(POGO))
    block = pick_trainer_block(B)
    state, layers, max_abs_err, _, _ = check_train_kernel("[3]", spec, block)
    obs_dim = layers[0][0].shape[1]

    # ---- 4. the main path: 3 PPO train steps through the kernel -----------
    cfg = PPOConfig(num_envs=B)
    init, train_step = make_train(cfg, device=dev)
    carry = init(SEED)
    count0 = carry[1].step_count.clone()
    torch.cuda.synchronize()
    TR.train_rollout.launches.update(native=0, pool=0)
    step_s = []
    for u in range(3):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, SEED + u + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = TR.train_rollout.launches["native"]
    m = {k: float(v) for k, v in metrics.items()}
    print(f"[4] 3 train steps: launches={launches} "
          f"step seconds={['%.6f' % s for s in step_s]} metrics={m}")
    if launches != 3 or TR.train_rollout.launches["pool"]:
        fail(f"the acting kernel launched {TR.train_rollout.launches} times "
             "in 3 train steps (expected native 3)")
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

    # ---- a. the rollout kernel's registers --------------------------------
    lines = log.splitlines()
    found = False
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "rollout_kernel" in line \
                and "train_rollout" not in line:
            found = True
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print("[a] rollout_kernel ptxas:", nxt.strip())
    if secs > 0 and not found:
        fail("ptxas reported no rollout_kernel")

    # ---- b. 'input' and 'prng' against the twin ---------------------------
    def compare_states(k, p, n=B):
        """Per env of ``n``: does every state field agree bit for bit?"""
        same = torch.ones(n, dtype=torch.bool, device=dev)
        for name, x in k.__dict__.items():
            y = getattr(p, name)
            same &= (x == y).reshape(n, -1).all(1)
        return same

    rs = np.random.RandomState(SEED % 2 ** 31)
    err = {"prng": 0.0, "input": 0.0}
    plain_t = {}
    runs = [("input", "NovelGridworld-Pogostick-v1"),
            ("prng", "NovelGridworld-Pogostick-v1"),
            ("input", "NovelGridworld-v5"), ("input", "NovelGridworld-v3"),
            ("input", "NovelGridworld-Pogostick-v0"),
            ("prng", "NovelGridworld-v2"), ("prng", "NovelGridworld-v4")]
    pogo_out = {}
    for source, env_id in runs:
        sp = nt.make_spec(env_id)
        acts = None
        if source == "input":
            acts = torch.as_tensor(rs.randint(sp.n_actions, size=(T, B)),
                                   dtype=torch.int32, device=dev)
        kw = dict(block=ROLLOUT_BLOCK, action_source=source, actions=acts,
                  device=dev)
        out_k = R.rollout(sp, B, T, SEED, **kw)
        torch.cuda.synchronize()
        out_p, p_ms = sync_ms(lambda: R.rollout_plain(
            sp, B, T, SEED, ROLLOUT_BLOCK, source, acts, device=dev))
        same = compare_states(out_k[0], out_p[0])
        n_state = int((~same).sum())
        n_sum = int((out_k[1] != out_p[1]).sum())
        n_cnt = int((out_k[2] != out_p[2]).sum())
        e = max(float((out_k[1] - out_p[1]).abs().max()),
                float((out_k[0].last_reward - out_p[0].last_reward)
                      .abs().max()),
                float((out_k[0].last_cost - out_p[0].last_cost).abs().max()))
        err[source] = max(err[source], e)
        n_done = int(out_k[2].sum())
        print(f"[b] {source:5s} {env_id} B={B} T={T}: {n_done} episode "
              f"ends, envs differing in state {n_state}, in reward sum "
              f"{n_sum}, in done count {n_cnt}; twin {p_ms:.4f} ms")
        if n_state or n_sum or n_cnt:
            fail(f"{source} kernel and twin disagree on {env_id}")
        if env_id in ("NovelGridworld-v2", "NovelGridworld-v3",
                      "NovelGridworld-v4") and n_done == 0:
            fail(f"no episode end on {env_id}: the resets went unchecked")
        if env_id == "NovelGridworld-Pogostick-v1":
            pogo_out[source] = (acts, out_k)
            plain_t[source] = p_ms

    # the main paths, each with the launch counts set to 0 just before it
    pogo = nt.make_spec("NovelGridworld-Pogostick-v1")
    R.rollout.launches.update(dict.fromkeys(R.SOURCES, 0))
    st_m, mean_m = throughput_fn(pogo, B, T, device=dev)(SEED)
    torch.cuda.synchronize()
    launches_prng = R.rollout.launches["prng"]
    R.rollout.launches.update(dict.fromkeys(R.SOURCES, 0))
    run_in = R.make_rollout(pogo, B, T, block=ROLLOUT_BLOCK,
                            action_source="input", device=dev)
    st_i, mean_i, n_i = run_in(SEED, pogo_out["input"][0])
    torch.cuda.synchronize()
    launches_input = R.rollout.launches["input"]
    print(f"[b] main paths: throughput_fn launched rollout:prng "
          f"{launches_prng}x (mean reward {float(mean_m)}), "
          f"make_rollout('input') launched rollout:input {launches_input}x "
          f"(mean reward {float(mean_i)}, {int(n_i)} episode ends)")
    if launches_prng < 1 or launches_input < 1:
        fail("a main path did not launch its rollout kernel")
    for name, st, out in (("throughput_fn", st_m, pogo_out["prng"][1]),
                          ("make_rollout", st_i, pogo_out["input"][1])):
        if not bool(compare_states(st, out[0]).all()):
            fail(f"{name}'s state differs from the compared kernel run")
        if st.map.shape != (B, pogo.map_size ** 2):
            fail(f"{name}'s map has the wrong shape")
    for mean in (mean_m, mean_i):
        if not math.isfinite(float(mean)):
            fail("a mean reward is not finite")

    # ---- c. 'policy' against train_rollout and against its twin ----------
    player = layers     # Pogostick-v1 under LidarInFront, hidden (64, 64)
    out_k = R.rollout(spec, B, T, SEED, POLICY_BLOCK, "policy",
                      pi_layers=player, device=dev)
    seeds, rows = block_streams(SEED, B, POLICY_BLOCK, dev)
    start = reset_rows(ResetTables(spec), seeds, 0, rows)
    out_t = TR.train_rollout(spec, start, player, SEED, T,
                             block=POLICY_BLOCK, cap=2 ** 30)
    rsum_t = torch.zeros(B, dtype=torch.float32, device=dev)
    for t in range(T):
        rsum_t = rsum_t + out_t[3][t]
    same_t = compare_states(out_k[0], out_t[0])
    n_sum_t = int((out_k[1] != rsum_t).sum())
    n_cnt_t = int((out_k[2] != out_t[4].sum(0)).sum())
    out_p = R.rollout_plain(spec, B, T, SEED, POLICY_BLOCK, "policy",
                            pi_layers=player, device=dev)
    same_p = compare_states(out_k[0], out_p[0]) & (out_k[1] == out_p[1]) \
        & (out_k[2] == out_p[2])
    share_p = int((~same_p).sum()) / B
    err_policy = float((out_k[1] - out_p[1]).abs()[same_p].max()) \
        if bool(same_p.any()) else float("inf")
    print(f"[c] policy B={B} T={T} block={POLICY_BLOCK}: vs train_rollout "
          f"(cap 2^30) {int((~same_t).sum())} envs differ in state, "
          f"{n_sum_t} in reward sum, {n_cnt_t} in done count; vs the twin "
          f"{share_p:.5%} of envs differ; {int(out_k[2].sum())} episode ends")
    if not bool(same_t.all()) or n_sum_t or n_cnt_t:
        fail("the policy rollout kernel and the train-rollout kernel disagree")
    if share_p > MAX_MISMATCH_SHARE:
        fail(f"{share_p:.3%} of envs differ from the policy twin")
    R.rollout.launches.update(dict.fromkeys(R.SOURCES, 0))
    run_pol = R.make_rollout(spec, B, T, block=POLICY_BLOCK,
                             action_source="policy", pi_layers=player,
                             device=dev)
    st_c, mean_c, n_c = run_pol(SEED)
    torch.cuda.synchronize()
    launches_policy = R.rollout.launches["policy"]
    print(f"[c] main path: make_rollout('policy') launched rollout:policy "
          f"{launches_policy}x (mean reward {float(mean_c)}, {int(n_c)} "
          "episode ends)")
    if launches_policy < 1:
        fail("the policy main path did not launch its kernel")
    if not bool(compare_states(st_c, out_k[0]).all()) \
            or not math.isfinite(float(mean_c)):
        fail("make_rollout('policy') differs from the compared kernel run")

    # ---- d. the legacy template through the train kernel ------------------
    v5 = nt.lidar_in_front(nt.make_spec("NovelGridworld-v5"))
    check_train_kernel("[d]", v5, pick_trainer_block(B))

    # ---- f. the train kernel's pool mode at full width ---------------------
    def novelty_spec(env_id, novs):
        rng = np.random.RandomState(0)
        sp = nt.make_spec(env_id)
        for args in novs:
            sp = nt.inject_novelty(sp, *args, rng=rng)
        return sp

    fence_m = nt.lidar_in_front(
        novelty_spec(POGO, (("fence", "medium", "oak"),)))
    n_pool, pool_seed = B * POOL_R, SEED + 1
    pool = R.pool_reset(fence_m, n_pool, pool_seed, device=dev)
    pool_p = reset_rows(ResetTables(fence_m), pool_seed, 0,
                        torch.arange(n_pool, device=dev))
    same = compare_states(pool, pool_p, n_pool)
    print(f"[f] the card's pool ({n_pool} rows, rollout kernel at T=0) vs "
          f"reset_rows on the card: {int((~same).sum())} rows differ; "
          f"{int((pool.map == fence_m.items.index('oak_fence')).any(1).sum())}"
          f" maps hold a fence")
    if not bool(same.all()):
        fail("the card's pool differs from reset_rows")
    _, pool_layers, pool_err, pool_out, pool_plain_ms = check_train_kernel(
        "[f]", fence_m, block, cap=POOL_CAP, pool=pool)
    restores = pool_out[4].sum(0)
    print(f"[f] restores an env: min {int(restores.min())}, max "
          f"{int(restores.max())}; base_out in [{int(pool_out[5].min())}, "
          f"{int(pool_out[5].max())}]")
    if int(restores.min()) < 6:
        fail("an env restored fewer than 6 times: the slots did not cycle")

    # ---- g. the main path: PPO on the novelty spec, pool resets ------------
    init_f, step_f = make_train(PPOConfig(num_envs=B), spec_override=fence_m,
                                device=dev)
    carry_f = init_f(SEED)
    torch.cuda.synchronize()
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.SOURCES, 0))
    R.pool_reset.launches = 0
    step_f.phases = {}
    eps = 0
    for u in range(3):
        carry_f, metrics_f = step_f(carry_f, SEED + u + 1)
        eps += int(metrics_f["episodes"])
        for k in ("pg_loss", "v_loss", "entropy"):
            if not math.isfinite(float(metrics_f[k])):
                fail(f"novelty train step {u}: {k} is not finite")
    torch.cuda.synchronize()
    launches_pool = TR.train_rollout.launches["pool"]
    gens, prng_g = R.pool_reset.launches, R.rollout.launches["prng"]
    print(f"[g] 3 train steps on fence medium: reset source "
          f"{step_f.reset_source}, train_rollout launches "
          f"{TR.train_rollout.launches}, pools drawn {gens} (rollout:prng "
          f"{prng_g}), {eps} episodes, last metrics "
          f"{ {k: float(v) for k, v in metrics_f.items()} }")
    if launches_pool != 3 or TR.train_rollout.launches["native"] or \
            gens != 3 or prng_g != 3:
        fail("the novelty train steps did not run the pool-mode kernel and "
             "the pool generator exactly 3 times each")
    if eps <= 0 or not torch.isfinite(carry_f[2]).all():
        fail("no episode ended in 3 novelty train steps, or the obs is "
             "not finite")
    init_0, step_0 = make_train(
        PPOConfig(env_id="NovelGridworld-Pogostick-v0", num_envs=B),
        device=dev)
    carry_0 = init_0(SEED)
    TR.train_rollout.launches.update(native=0, pool=0)
    carry_0, metrics_0 = step_0(carry_0, SEED + 1)
    torch.cuda.synchronize()
    print(f"[g] one train step on Pogostick-v0: reset source "
          f"{step_0.reset_source}, train_rollout launches "
          f"{TR.train_rollout.launches}, pg_loss "
          f"{float(metrics_0['pg_loss'])}")
    if step_0.reset_source != "pool" or \
            TR.train_rollout.launches != {"native": 0, "pool": 1}:
        fail("Pogostick-v0 did not train on the pool source")

    # ---- h. the novelty step and reset edits on the card -------------------
    rs_h = np.random.RandomState(SEED % 2 ** 31 + 1)
    runs_h = [("input", e, n) for e, n in NOVELTIES] + [
        ("prng", POGO, (("firewall", "hard"),)),
        ("prng", POGO, (("fence", "hard", "oak"),))]
    for source, env_id, novs in runs_h:
        sp = novelty_spec(env_id, novs)
        acts = None
        if source == "input":
            acts = torch.as_tensor(rs_h.randint(sp.n_actions, size=(T, B)),
                                   dtype=torch.int32, device=dev)
        out_k = R.rollout(sp, B, T, SEED, ROLLOUT_BLOCK, source, acts,
                          device=dev)
        out_p = R.rollout_plain(sp, B, T, SEED, ROLLOUT_BLOCK, source, acts,
                                device=dev)
        same = compare_states(out_k[0], out_p[0]) & (out_k[1] == out_p[1]) \
            & (out_k[2] == out_p[2])
        err[source] = max(err[source],
                          float((out_k[1] - out_p[1]).abs().max()))
        print(f"[h] {source:5s} {env_id} {sp.novelty_tag}: "
              f"{int(out_k[2].sum())} episode ends, "
              f"{int((~same).sum())} envs differ")
        if not bool(same.all()):
            fail(f"{source} kernel and twin disagree on {sp.novelty_tag}")
    fence_e = nt.lidar_in_front(
        novelty_spec(POGO, (("fence", "easy", "oak"),)))
    check_train_kernel("[h]", fence_e, block)

    # ---- e. rates on the card's clock --------------------------------------
    for b_rate in RATE_BATCHES:
        run = throughput_fn(pogo, b_rate, RATE_T, device=dev)
        ms = event_ms(lambda: run(SEED))
        print(f"[e] {smi}: throughput_fn Pogostick-v1 B={b_rate} "
              f"T={RATE_T}: {ms:.4f} ms = "
              f"{b_rate * RATE_T / ms * 1e3:.1f} env-steps/s")
    rate = {}
    for source in ("prng", "input"):
        acts = pogo_out["input"][0] if source == "input" else None
        rate[source] = device_ms(lambda: R.rollout(
            pogo, B, T, SEED, ROLLOUT_BLOCK, source, acts, device=dev))
        print(f"[e] {smi}: rollout:{source} B={B} T={T}: kernel (device) "
              f"{rate[source]:.4f} ms = {B * T / rate[source] * 1e3:.1f} "
              f"env-steps/s; twin {plain_t[source]:.4f} ms = "
              f"{B * T / plain_t[source] * 1e3:.1f} env-steps/s")
    rate["policy"] = device_ms(lambda: R.rollout(
        spec, B, POLICY_RATE_T, SEED, POLICY_BLOCK, "policy",
        pi_layers=player, device=dev))
    _, plain_t["policy"] = sync_ms(lambda: R.rollout_plain(
        spec, B, POLICY_RATE_T, SEED, POLICY_BLOCK, "policy",
        pi_layers=player, device=dev))
    print(f"[e] {smi}: rollout:policy B={B} T={POLICY_RATE_T} hidden "
          f"{HIDDEN}: kernel (device) {rate['policy']:.4f} ms = "
          f"{B * POLICY_RATE_T / rate['policy'] * 1e3:.1f} env-steps/s; "
          f"twin {plain_t['policy']:.4f} ms = "
          f"{B * POLICY_RATE_T / plain_t['policy'] * 1e3:.1f} env-steps/s")

    # ---- i. rates under novelty, on the card's clock ----------------------
    base0 = torch.zeros(B, dtype=torch.int32, device=dev)
    start_f = nt.counter_reset(fence_m, SEED, 0, B, device=dev)
    mode_ms = {"pool": [], "native": []}
    for mode in ("pool", "native", "native", "pool"):
        kw = dict(pool=pool, base=base0) if mode == "pool" else {}
        mode_ms[mode].append(event_ms(lambda: TR.train_rollout(
            fence_m, start_f, pool_layers, SEED, T, block=block,
            cap=POOL_CAP, **kw), reps=10))
    pool_ms = sum(mode_ms["pool"]) / 2
    print(f"[i] {smi}: train kernel on fence medium, B={B} T={T} cap "
          f"{POOL_CAP}, by events over 10 launches in turns: pool mode "
          f"{mode_ms['pool']} ms, native mode {mode_ms['native']} ms")
    gen_ms = device_ms(lambda: R.pool_reset(fence_m, n_pool, pool_seed,
                                            device=dev))
    print(f"[i] {smi}: the pool generator ({n_pool} resets of fence "
          f"medium, rollout kernel at T=0): {gen_ms:.4f} ms device time")
    for name, secs in step_f.phases.items():
        print(f"[i] {smi}: novelty train step (fence medium, B={B} T={T}) "
              f"phase {name}: {['%.6f' % (x * 1e3) for x in secs]} ms")
    print(f"[i] {smi}: Pogostick-v1 train kernel (native) {kernel_ms:.4f} ms "
          "(phase 5)")
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and ("registers" in line or "spill" in line):
            print(f"[i] ptxas {entry}: {line.strip()}")

    # ---- j. the tile MLP: instantiations, ptxas, shared memory, times -----
    def train_run(novelty):
        """The phase-3 launch on Pogostick-v1 through the plain or the
        novelty instantiation (the wrapper picks it from has_novelty)."""
        TR.has_novelty = (lambda sp: True) if novelty else has_novelty
        try:
            return TR.train_rollout(spec, state, layers, SEED, T, block=block,
                                    cap=CAP)
        finally:
            TR.has_novelty = has_novelty

    plain_out, nov_out = train_run(False), train_run(True)
    torch.cuda.synchronize()
    same_nov = all(torch.equal(getattr(plain_out[0], k), getattr(
        nov_out[0], k)) for k in plain_out[0].__dict__) and all(
        torch.equal(x, y) for x, y in zip(plain_out[1:], nov_out[1:]))
    inst_ms = {False: [], True: []}
    for novelty in (False, True, True, False):
        inst_ms[novelty].append(event_ms(lambda: train_run(novelty), reps=10))
    print(f"[j] {smi}: the train kernel's novelty instantiation on "
          f"Pogostick-v1 (B={B} T={T}) equals the plain one bit for bit: "
          f"{same_nov}; by events over 10 launches in turns: plain "
          f"{inst_ms[False]} ms, novelty {inst_ms[True]} ms")
    if not same_nov:
        fail("the novelty instantiation changes a Pogostick-v1 result")
    lib = _build.load_library()
    for name, sp, dims_j, stage in (
            ("train_rollout_kernel", spec, [obs_dim, *HIDDEN, spec.n_actions],
             1),
            ("policy_rollout_kernel", spec, [obs_dim, *HIDDEN, spec.n_actions],
             0)):
        tab = kernel_tables(sp, dims_j)
        envs = TR.ENVS if stage else R.POLICY_ENVS
        nbytes = lib.ngx_tile_smem(
            int(tab.size), c_ints(dims_j), len(dims_j), envs,
            int(sp.map_size) ** 2, int(sp.n_items), stage)
        print(f"[j] {name}: {envs} envs x "
              f"{TR.THREADS if stage else R.THREADS['policy']} threads a "
              f"block, {nbytes} bytes of dynamic shared memory at hidden "
              f"{HIDDEN}")
        if nbytes <= 0:
            fail(f"{name}: no shared-memory layout")
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and ("train_rollout_kernel" in entry
                        or "policy_rollout_kernel" in entry) \
                and ("registers" in line or "spill" in line):
            print(f"[j] ptxas {entry}: {line.strip()}")
    print(f"[j] {smi}: tile-MLP kernels at B={B}: train native "
          f"(Pogostick-v1, T={T}) {kernel_ms:.4f} ms, train pool (fence "
          f"medium) {pool_ms:.4f} ms, policy (T={POLICY_RATE_T}) "
          f"{rate['policy']:.4f} ms device")

    # ---- the kernels' record -------------------------------------------------
    def bound(spec, dims, batch, steps, source, pool_rows=0):
        """(ms, 'bytes' or 'operations'): the state in and out, the tables,
        the weights, the trajectory ('train'), the action stream ('input'),
        the pool and its bases, each once, over 3.35 TB/s; the MLP's
        float32 multiply-adds (2 operations each) over 67 TFLOP/s."""
        hw, ni = spec.map_size ** 2, spec.n_items
        state = batch * (hw + 7 + 2 + ni) * 4
        pairs = list(zip(dims[:-1], dims[1:]))
        params = sum(a * b + b for a, b in pairs) * 4
        nbytes = kernel_tables(spec, dims).size * 4 + params + state
        if source == "train":
            nbytes += state + steps * batch * (dims[0] * 4 + 4 + 4 + 1)
            nbytes += pool_rows * (hw + ni + 4) * 4
            nbytes += 2 * batch * 4 if pool_rows else 0
        else:
            nbytes += batch * 8                  # reward sums, done counts
            nbytes += steps * batch * 4 if source == "input" else 0
        ops = 2 * sum(a * b for a, b in pairs) * batch * steps if dims else 0
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    # ---- k. the warp-redesigned 'prng' / 'input' path ----------------------
    firewall = (("firewall", "hard"),)
    runs_k = [("prng", "NovelGridworld-v3", (), B, ROLLOUT_BLOCK),
              ("prng", POGO, firewall, B, ROLLOUT_BLOCK),
              ("prng", POGO, firewall + (("fence", "easy", "oak"),), B,
               ROLLOUT_BLOCK),
              ("input", "NovelGridworld-v2", (), B, ROLLOUT_BLOCK),
              ("prng", "NovelGridworld-v3", (), RAGGED_B, RAGGED_BLOCK)]
    rs_k = np.random.RandomState(SEED % 2 ** 31 + 2)
    for source, env_id, novs, bk, blk in runs_k:
        sp = novelty_spec(env_id, novs)
        acts = None
        if source == "input":
            acts = torch.as_tensor(rs_k.randint(sp.n_actions, size=(T, bk)),
                                   dtype=torch.int32, device=dev)
        out_k = R.rollout(sp, bk, T, SEED, blk, source, acts, device=dev)
        out_p = R.rollout_plain(sp, bk, T, SEED, blk, source, acts,
                                device=dev)
        same = compare_states(out_k[0], out_p[0], bk) \
            & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
        err[source] = max(err[source],
                          float((out_k[1] - out_p[1]).abs().max()))
        n_done = int(out_k[2].sum())
        print(f"[k] {source:5s} {env_id} {sp.novelty_tag} B={bk} block={blk} "
              f"T={T}: {n_done} episode ends, {int((~same).sum())} envs "
              "differ")
        if not bool(same.all()):
            fail(f"{source} kernel and twin disagree on {env_id} "
                 f"{sp.novelty_tag} at B={bk}")
        if n_done == 0:
            fail(f"no episode end on {env_id} {sp.novelty_tag}: the warp "
                 "resets went unchecked")
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "14rollout_kernel" in entry \
                and ("registers" in line or "spill" in line):
            print(f"[k] ptxas {entry}: {line.strip()}")
    for sp in (pogo, fence_m):
        tab = kernel_tables(sp)
        lanes = ctypes.c_int(R.RESET_LANES)
        nbytes = lib.ngx_rollout_smem(
            int(tab.size), int(sp.map_size) ** 2, int(sp.n_items),
            int(has_novelty(sp) and bool(sp.reset_edits)),
            R.THREADS["prng"], ctypes.byref(lanes))
        print(f"[k] rollout_kernel on {sp.env_id} {sp.novelty_tag}: "
              f"{R.THREADS['prng']} threads a block, {nbytes} bytes of "
              f"dynamic shared memory, resets of at least {lanes.value} "
              "lanes")
        if nbytes <= 0:
            fail("no shared-memory layout for the rollout kernel")
    for b_rate in RATE_BATCHES:
        run = throughput_fn(pogo, b_rate, RATE_T, device=dev)
        ms = device_ms(lambda: run(SEED))
        b_ms, b_by = bound(pogo, [], b_rate, RATE_T, "prng")
        print(f"[k] {smi}: throughput_fn Pogostick-v1 B={b_rate} "
              f"T={RATE_T}: kernel (device) {ms:.4f} ms = "
              f"{b_rate * RATE_T / ms * 1e3:.1f} env-steps/s; bound "
              f"{b_ms:.4f} ms ({b_by})")
    b_ms, b_by = bound(fence_m, [], n_pool, 0, "prng")
    print(f"[k] {smi}: the pool draw ({n_pool} resets of fence medium at "
          f"T=0): {gen_ms:.4f} ms device time (phase i); bound {b_ms:.4f} "
          f"ms ({b_by})")

    # ---- l. the pool-mode train kernel on the chain pool ------------------
    root = os.path.dirname(os.path.abspath(__file__))
    agents = os.path.join(root, "trained_agents_torch")
    stages = [restore_checkpoint(os.path.join(agents, "chain", e, "best.pt"))
              ["params"] for e in CHAIN[:-1]]
    solver = restore_checkpoint(os.path.join(agents, "chain_solver_v5",
                                             "best.pt"))["params"]
    farmer = restore_checkpoint(os.path.join(agents, "chain", CHAIN[-1],
                                             "best.pt"))["params"]
    bc_data = load_demos(os.path.join(root, "demos", "NovelGridworld-v5.npz"))
    cfg_c = PPOConfig(env_id=CHAIN[-1], num_envs=B, solve_shaped=True,
                      bc_coef=0.05)
    init_l, _ = make_train_chain(cfg_c, CHAIN, stages, bc_data=bc_data,
                                 device=dev)
    _, start_l, _, _, base_l, pool_l, _ = init_l(SEED)
    rows_l = torch.randint(0, pool_l.batch, (B * POOL_R,),
                           generator=torch.Generator().manual_seed(SEED))
    pool_lr = pool_l.take(rows_l.to(dev))
    solver_model = ActorCritic(obs_dim_of(v5), v5.n_actions, HIDDEN)
    solver_model.load_state_dict(solver)
    solver_layers = [(w.detach().to(dev), b.detach().to(dev))
                     for w, b in solver_model.pi_layers()]
    inv_max = int(pool_l.inventory.max())
    print(f"[l] the chain pool: {pool_l.batch} rows of {CHAIN[-1]} after "
          f"{' -> '.join(CHAIN[:-1])} (stages from trained_agents_torch/"
          f"chain), step_count in [{int(pool_l.step_count.min())}, "
          f"{int(pool_l.step_count.max())}], largest inventory {inv_max}; "
          f"the init's base in [{int(base_l.min())}, {int(base_l.max())}]")
    if int(base_l.max()) <= 0:
        fail("the init's base is zero: the chain stages played no step")
    _, _, chain_err, chain_out, chain_plain_ms = check_train_kernel(
        "[l]", v5, block, cap=CAP, pool=pool_lr, start=start_l, base=base_l,
        layers=solver_layers)
    print(f"[l] restores an env: max {int(chain_out[4].sum(0).max())}; "
          f"base_out in [{int(chain_out[5].min())}, "
          f"{int(chain_out[5].max())}]")
    chain_ms = event_ms(lambda: TR.train_rollout(
        v5, start_l, solver_layers, SEED, T, block=block, cap=CAP,
        pool=pool_lr, base=base_l), reps=10)
    print(f"[l] {smi}: the pool-mode train kernel on the chain pool (B={B} "
          f"T={T} R={POOL_R} cap {CAP}, chain_solver_v5's policy): "
          f"{chain_ms:.4f} ms by events over 10 launches; twin "
          f"{chain_plain_ms:.4f} ms")
    # the chain's stage-0 draw (make_chain_reset's pool_reset: the rollout
    # kernel at T 0 on the first stage's spec, P rows) against reset_rows
    v2 = nt.lidar_in_front(nt.make_spec(CHAIN[0]))
    n_draw, draw_seed = pool_l.batch, SEED + 4
    rows_d = torch.arange(n_draw, device=dev)
    draw = R.pool_reset(v2, n_draw, draw_seed, device=dev)
    draw_p = reset_rows(ResetTables(v2), draw_seed, 0, rows_d)
    same = compare_states(draw, draw_p, n_draw)
    draw_err = max(float((x.long() - getattr(draw_p, name).long()).abs()
                         .max()) for name, x in draw.__dict__.items())
    draw_ms = event_ms(lambda: R.pool_reset(v2, n_draw, draw_seed,
                                            device=dev))
    draw_plain_ms = event_ms(lambda: reset_rows(ResetTables(v2), draw_seed, 0,
                                                rows_d))
    print(f"[l] {smi}: the chain's stage-0 draw ({n_draw} resets of "
          f"{CHAIN[0]}, rollout kernel at T=0) vs reset_rows on the card: "
          f"{int((~same).sum())} rows differ, max |err| {draw_err}; "
          f"{draw_ms:.4f} ms by events, reset_rows {draw_plain_ms:.4f} ms")
    if not bool(same.all()):
        fail("the chain's stage-0 draw differs from reset_rows")

    # ---- m. the main path: the chain trainer, counted ----------------------
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.SOURCES, 0))
    R.pool_reset.launches = 0
    init_m, step_m = make_train_chain(cfg_c, CHAIN, stages, bc_data=bc_data,
                                      device=dev)
    carry_m = init_m(SEED + 1)
    step_m.phases = {}
    carry_m = step_m.refresh_pool(carry_m, SEED + 2)
    eps_m = []
    for u in range(3):
        carry_m, metrics_m = step_m(carry_m, SEED + 3 + u)
        eps_m.append(int(metrics_m["episodes"]))
        for k in ("pg_loss", "v_loss", "entropy"):
            if not math.isfinite(float(metrics_m[k])):
                fail(f"chain train step {u}: {k} is not finite")
    torch.cuda.synchronize()
    launches_chain = TR.train_rollout.launches["pool"]
    draws_chain = R.pool_reset.launches
    print(f"[m] make_train_chain({CHAIN[-1]}, B={B}, T={T}, solve_shaped, "
          f"bc_coef 0.05 on {bc_data[0].shape[0]} demo frames): init, one "
          f"refresh_pool, 3 train steps: train_rollout launches "
          f"{TR.train_rollout.launches}, pool_reset draws {draws_chain}, "
          f"episodes a step {eps_m}, last metrics "
          f"{ {k: float(v) for k, v in metrics_m.items()} }")
    for name, secs in step_m.phases.items():
        print(f"[m] {smi}: chain train step (B={B} T={T}, P "
              f"{pool_l.batch}, 3 stages x cap {CAP}) phase {name}: "
              f"{['%.6f' % (x * 1e3) for x in secs]} ms")
    if launches_chain != 3 or TR.train_rollout.launches["native"] or \
            draws_chain != 2:
        fail("the chain trainer did not launch the pool-mode kernel exactly "
             "3 times and draw stage 0 exactly twice")
    # the init's base is each env's step_count, so no env meets the cap
    # (100 > T) in the first step: episodes are counted over the 3 steps
    if sum(eps_m) < B or min(eps_m) < 1:
        fail(f"episodes a chain train step {eps_m}: expected at least one "
             f"each and {B} over the three")
    if not torch.isfinite(carry_m[2]).all() or carry_m[2].shape != (
            B, obs_dim_of(v5)):
        fail("the chain carry's obs is not finite or has the wrong shape")

    # ---- n. evaluation on the card -----------------------------------------
    evals = {}
    for name, final, bounds in (
            ("chain_solver_v5", solver,
             (("solve_rate", 0.99, 1.0), ("mean_return", 45.5, 47.0))),
            ("chain NovelGridworld-v5", farmer,
             (("solve_rate", 0.0, 0.01), ("mean_return", 1350.0, 1470.0)))):
        out, ms = sync_ms(lambda: evaluate_chain(
            CHAIN, stages, final, episodes=EVAL_EPISODES, seed=SEED,
            device=dev))
        evals[name] = ms
        print(f"[n] {smi}: evaluate_chain({' -> '.join(CHAIN)}, final "
              f"{name}, {EVAL_EPISODES} episodes): {out}, {ms:.4f} ms")
        check_bounds(f"evaluate_chain with {name}", out, bounds)
    pogo_ck = os.path.join(agents, "NovelGridworld-Pogostick-v1_solver",
                           "best.pt")
    out, ms = sync_ms(lambda: evaluate_checkpoint(
        POGO, pogo_ck, episodes=EVAL_EPISODES, seed=SEED, device=dev))
    print(f"[n] {smi}: evaluate_checkpoint({POGO}, its solver, "
          f"{EVAL_EPISODES} episodes): {out}, {ms:.4f} ms (trained and "
          "random)")
    check_bounds("the Pogostick-v1 solver", out["trained"], (
        ("solve_rate", 0.99, 1.0), ("mean_length", 31.5, 33.5),
        ("mean_return", 138.0, 141.5)))
    check_bounds("the random Pogostick-v1 policy", out["random"], (
        ("mean_return", -89.0, -80.0), ("done_rate", 0.0, 0.0)))
    run_eval = make_eval(nt.make_spec(POGO), device=dev)
    pogo_params = restore_checkpoint(pogo_ck)["params"]
    _, evals["make_eval"] = sync_ms(lambda: run_eval(pogo_params, SEED,
                                                     EVAL_EPISODES))
    print(f"[n] {smi}: make_eval({POGO}, the solver, {EVAL_EPISODES} "
          f"episodes): {evals['make_eval']:.4f} ms")

    # ---- o. the training CLI end to end ------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        argv = [sys.executable, "-m", "ngx_torch.cli.train",
                "-chain", ",".join(CHAIN), "-chain_ckpts",
                os.path.join(agents, "chain"), "-num_envs", str(B),
                "-updates_per_launch", "2", "-reward_mode", "solve",
                "-bc_anchor", os.path.join(root, "demos",
                                           "NovelGridworld-v5.npz")]
        for extra in (["-steps", str(3 * B * T), "-ckpt", ck, "-log", log],
                      ["-steps", str(B * T), "-resume",
                       os.path.join(ck, "resume.pt"), "-ckpt", ck + "2",
                       "-log", log + "2"]):
            t0 = time.perf_counter()
            proc = subprocess.run(argv + extra, cwd=root, capture_output=True,
                                  text=True, timeout=600)
            secs = time.perf_counter() - t0
            tail = proc.stdout.strip().splitlines()[-3:]
            print(f"[o] {' '.join(argv[1:3] + extra[:2])}"
                  f"{' -resume' if '-resume' in extra else ''}: rc "
                  f"{proc.returncode}, {secs:.3f} s; {tail}")
            if proc.returncode != 0:
                fail(f"the training CLI failed:\n{proc.stdout[-4000:]}\n"
                     f"{proc.stderr[-4000:]}")
        for name in ("best.pt", "final.pt", "resume.pt"):
            if not os.path.isfile(os.path.join(ck, name)):
                fail(f"the CLI wrote no {name}")
        with open(os.path.join(log, "progress.monitor.csv")) as f:
            lines = f.read().splitlines()
        if not lines[0].startswith("#") or lines[1] != "r,l,t" or \
                len(lines) != 5:
            fail(f"the monitor CSV is not a header and 3 rows: {lines}")
        final = restore_checkpoint(os.path.join(ck, "final.pt"))["params"]
        out = evaluate_chain(CHAIN, stages, final, episodes=EVAL_EPISODES,
                             seed=SEED, device=dev)
        print(f"[o] evaluate_chain on the CLI's final.pt: {out}; monitor "
              f"rows {lines[2:]}")
        if not all(math.isfinite(v) for v in out.values()):
            fail("the CLI's final checkpoint evaluates to non-finite metrics")

    dims = [obs_dim, *HIDDEN, spec.n_actions]
    dims_f = [pool_layers[0][0].shape[1], *HIDDEN, fence_m.n_actions]
    dims_c = [solver_layers[0][0].shape[1], *HIDDEN, v5.n_actions]
    records = [
        ("train_rollout:native", "train_rollout.cu", ":812", launches,
         {"make_train(Pogostick-v1)": launches}, max_abs_err, kernel_ms,
         plain_ms, bound(spec, dims, B, T, "train")),
        ("train_rollout:pool", "train_rollout.cu", ":812", launches_pool,
         {"make_train(fence medium)": launches_pool}, pool_err, pool_ms,
         pool_plain_ms, bound(fence_m, dims_f, B, T, "train", n_pool)),
        ("train_rollout:pool:chain", "train_rollout.cu", ":812",
         launches_chain, {"make_train_chain(v2..v5)": launches_chain},
         chain_err, chain_ms, chain_plain_ms,
         bound(v5, dims_c, B, T, "train", B * POOL_R)),
        ("rollout:prng", "rollout.cu", ":533", prng_g,
         {"make_train(fence medium) pools": prng_g,
          "throughput_fn": launches_prng}, err["prng"], rate["prng"],
         plain_t["prng"], bound(pogo, [], B, T, "prng")),
        ("rollout:prng:chain-draw", "rollout.cu", ":533", draws_chain,
         {"make_train_chain(v2..v5) stage-0 draws": draws_chain}, draw_err,
         draw_ms, draw_plain_ms, bound(v2, [], n_draw, 0, "prng")),
        ("rollout:input", "rollout.cu", ":533", launches_input,
         {"make_rollout('input')": launches_input}, err["input"],
         rate["input"], plain_t["input"], bound(pogo, [], B, T, "input")),
        ("rollout:policy", "rollout.cu", ":533", launches_policy,
         {"make_rollout('policy')": launches_policy}, err_policy,
         rate["policy"], plain_t["policy"],
         bound(spec, dims, B, POLICY_RATE_T, "policy")),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": f"ngx_torch/ops/csrc/{src}",
        "replaces": f"ngx/ops/pallas_rollout.py{line}", "launches": n,
        "paths": paths, "max_abs_err": e, "ms": ms, "plain_ms": p_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
    } for name, src, line, n, paths, e, ms, p_ms, b in records]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
