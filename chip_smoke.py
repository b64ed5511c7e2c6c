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
   3 PPO train steps on ngx's keys (the init on ``key(SEED)``, update ``u``
   on ``fold_in(key, u + 1)``, ngx's ``train`` schedule), which must launch
   the kernel exactly 3 times and give finite losses;
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
   ``torch.profiler``, or by CUDA events around each launch where the
   profiler records none (at T = 64 a call's host work outlasts the
   kernel, so events around the call would time the host).

Then training under novelty (fence medium is ``inject_novelty(
Pogostick-v1, "fence", "medium", "oak")`` under LidarInFront):

f. the train kernel's pool mode on fence medium, B = 8192, T = 64, hidden
   (64, 64), R = 4, cap 10 (every env restores at least 6 times, so the
   slots cycle), against its twin from the same state, weights, seed and
   pool, as in phase 3, ``base_out`` included; the pool, drawn on the card
   by the rollout kernel at T = 0 in one RNG block of B*R envs, equal to
   ``reset_rows`` run on the card;
g. the main path: ``make_train(PPOConfig(num_envs=8192),
   spec_override=fence medium)`` for 3 train steps on phase 4's keys,
   which must launch the
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
   (two reset edits at every boundary), 'input' on v2, 'prng' on v3 at
   B = 8100 in blocks of 450 (a ragged last warp), and 'prng' on fence
   medium at B = 65536, the launch whose reset lanes the residency rule
   widens (it must take lanes 2, counted in ``rollout.widened``; its start
   reset is what the twin holds, no episode ending); ptxas's registers and
   spills of ``rollout_kernel<false>`` and ``<true>`` and a block's dynamic
   shared memory; ``throughput_fn``'s device time at B = 8192, 65536 and
   262144, T = 1024, on Pogostick-v1 and on fence medium, each beside the
   geometry the library launched (``ops/rollout.py`` ``launch.geometry``:
   threads, reset lanes, blocks an SM, waves, widened), and the pool
   draw's (phase i).

Then the curriculum chain (``ngx_torch/rl/curriculum.py``: the reference's
restore-chaining sweep NovelGridworld-v2 -> v3 -> v4 -> v5, the stage agents
from ``trained_agents_torch/chain``):

l. the train kernel's pool mode against its twin on the chain pool: B =
   8192, T = 64, hidden (64, 64), R = 4, cap 100 from the init's nonzero
   base, chain_solver_v5's policy, ``base_out`` included; the pool's largest
   inventory; the chain's stage-0 draw (ngx's native reset kernel, 1024
   rows of NovelGridworld-v2 on the keys the init's chain derives) against
   its plain twin on the card, and equal to the state a chain of
   NovelGridworld-v2 alone (no stage played) draws from the init's key;
m. the main path: ``make_train_chain(PPOConfig(env_id="NovelGridworld-v5",
   num_envs=8192, solve_shaped=True, bc_coef=0.05), ...)`` with the v5
   demos as the BC anchor: init, one ``refresh_pool``, 3 train steps, each
   on its own key, which must launch the pool-mode kernel exactly 3 times
   and draw stage 0 by the native reset exactly twice (no rollout kernel),
   with finite losses and at least B episodes
   over the three steps (the init's base is each env's step count, so no
   env meets the cap of 100 inside the first 64 steps); each step by phase;
n. evaluation at 1024 episodes, each metric held to a range around the JAX
   reference's own numbers: ``evaluate_chain`` with chain_solver_v5 and with
   the v5 farming agent, ``evaluate_checkpoint`` on the Pogostick-v1 solver
   (trained and random), and ``make_eval``'s time;
o. the training CLI in a subprocess: a 3-update chain run with the BC
   anchor, a 1-update ``-resume`` of it, its monitor CSV, and
   ``evaluate_chain`` on the ``final.pt`` it saved.

Then ngx's perf breakdown and acting-backend A/B:

p. the ablations of ``throughput_fn`` (variants of the 'prng' kernel):
   'hash' actions, a fixed action, no auto-reset and the packed final state,
   each bit for bit against the twin at B = 8192, T = 64 on Pogostick-v1,
   v3 and firewall hard, packed also against the unpacked kernel; every
   rollout-kernel variant's ptxas registers and spills and its SASS
   instruction and ``BSSY`` counts (``cuobjdump``); each ablation's main
   path, ``throughput_fn(..., ablation)``, counted; the five variants'
   device time at B = 8192, 65536 and 262144, T = 1024, in order; the
   full variant's device time by CUDA events around each
   launch against the profiler's;
q. the unfused acting backend (``rollout_backend='xla'``): its loop
   (``rollout_unfused``) under the kernel's own Gumbel noise with
   ``VecEnv``'s counter resets against the kernel's rollout from phase 3's
   state, weights and seed, to phase 3's rule; 3 ``make_train`` steps on Pogostick-v1 and on fence medium
   through it, which must launch no kernel and draw no pool, and 3 kernel
   steps on Pogostick-v1, each by phase; one ``make_train_chain`` step
   through it (no kernel launched in the step) beside phase m's; the
   training CLI with ``-rollout_backend xla`` for one update in a
   subprocess.

Then the multi-device layer (``ngx_torch/parallel``, ``make_train(cfg,
mesh)``; Pogostick-v1 and fence medium under LidarInFront, B = 8192, T =
64, hidden (64, 64), 4 x 8 minibatches, 3 steps each):

r. W 1 — rank 0 of 1 in this process, NCCL on ``cuda:0``: the main path
   ``make_train(cfg, mesh, 'pallas')``, counted (one acting launch a step;
   on fence medium one pool draw a step too), its state, last obs,
   trajectory and episode counts bit for bit against the unsharded
   ``make_train``'s from the same keys and permutations (both steps given
   the same ones through the trainer's ``epoch_perms``: the mesh's own
   draw is ``fold_in(k_upd, rank)``), its parameters
   within rtol 1e-5 / atol 1e-6 (the mesh takes ngx's moment form of the
   advantage normalization, not ``adv.std()``); W 2 — two processes on the
   one card, gloo over CUDA tensors (``spawn_ranks``): each rank counted,
   its acting at steps 1 and 2 equal to the kernel on its shard's inputs
   (its rows of the state, its shard seed, on fence medium its rows of the
   global pool and a zero base), step 2's launch (where the cap ends every
   episode) held by phase 3's rule against the plain twin run on CPU
   copies of the same inputs, the parameters equal on both ranks and bit
   for bit the in-process twin's (two threads over ``make_local_meshes``,
   the gradients summed by hand) after every step; the collectives of a step printed and checked
   (only all-reduces: one gradient bucket a minibatch of the parameters'
   bytes, the moments, the loss terms, the metrics); the sharded env
   stepping (``sharded_throughput_fn``, ``make_spmd_rollout`` plain and
   packed) at W 1 and 2, B = 65536, T = 1024: each rank's state its rows
   of ``throughput_fn``'s, the metrics the twin's, packed equal to plain.
   (``rl/scaling.py``'s ``measure_scaling((1, 2))``, now on ngx's keys,
   runs in phase z.)

Then the single-env facade and its drivers (``ngx_torch.compat``, the
scripted experts, ``ngx_torch.cli`` enjoy / record_demos / dagger,
``ngx_torch.rl.sb2``; plain torch at B = 1, no kernel):

s. the facade on the card against the CPU: the 11 presets,
   LidarInFront(Pogostick-v1), fence medium through ``compat.
   inject_novelty`` and LimitActions over Pogostick-v1, 4 random-action
   episodes each (``numpy.random``, cap 100), and the restore chain v1 ->
   v2 -> v3 -> v4 -> v3: every obs (value and dtype), reward, done and info
   equal, and each device's ms a facade step; ``evaluate_expert`` on
   Pogostick-v1 at 128 episodes and on the other 10 envs at 8, its dicts
   equal on both devices; ``sb2_apply`` of a zip built from seeded weights
   on the card against the CPU (rtol and atol 1e-6) and
   ``evaluate_sb2_zip`` on NovelGridworld-v0 at 128 episodes on the card;
   a facade step with the solver's keyed draw (the key split and the
   ``categorical`` on the host) against the counter draw it replaced and
   no policy, 200 steps each, and the host's split and categorical alone;
   the drivers on ngx's keys on the card and on the CPU, each policy draw
   traced: ``enjoy`` with the Pogostick-v1 solver (8 episodes) and on the
   v5 chain with ``trained_agents_torch/chain``, ``record_demos``
   ``-policy expert`` and ``-policy ckpt`` (4 episodes, the npz layout
   checked), ``dagger`` on Pogostick-v0 (hidden 64,64, 128 evaluation
   episodes, 2 rounds of 16 episodes, 500 BC steps and taus 1,2, against
   ngx's 8, 64, 4,000 and 1,2,4,8) whose ``best.pt`` loads through
   ``enjoy.load_policy``; by the first-mismatch rule (the same keys, the
   actions equal up to the first apart, which must sit at a near-tie of
   the CPU's Gumbel scores; nothing compared after it) the transcripts,
   the npz rows and dagger's round lines (the rounds no mismatched
   collection fed: the dataset equal, ``bc_acc`` and ``solve`` within 1%,
   the return within 2) equal on both; each part by the host clock, and
   the phase's own time.

Then the last modules of ngx (``ngx_torch.utils.debug``, ``.monitor``,
``ngx_torch.transforms.trajectories``, ``ngx_torch.cli`` socket_env /
keyboard_play / eval_agents):

t. ``NGX_DEBUG=1`` on the card: a fresh ``make_step``, ``counter_reset``
   and ``make_vec`` through a clean 100-step random run at B = 8192 (cap
   25, so envs reset), a negative inventory, a broken wall ring and a
   batched violation each raising ngx's text (the batched one naming its
   env index), ``throughput_fn`` and ``make_train`` refused, one
   ``make_train(..., rollout_backend='xla')`` step, and the plain step's
   time against the debug step's (the flag restored after); a random
   facade episode recorded by ``TrajectoryRecorder`` on the card and on the
   CPU, the pickles equal; ``Monitor`` over 3 episodes, its rows equal the
   CPU's and read back by ``load_results`` / ``ts2xy``; a card
   ``socket_env`` server on a free localhost port answering 20 actions
   sent by socket_agent's protocol, every reply equal to the CPU server's;
   ``keyboard_play -device cuda`` in a subprocess on a scripted stdin, its
   transcript equal to ``-device cpu``'s; ``eval_agents`` on ngx's keys on
   NovelGridworld-v0 and Pogostick-v1 at 128 episodes, seed 0, with the
   chain section: the trained, random and solver rows equal to ngx's
   ``results/eval.json``, the chain rows equal to ``docs/EVAL.md``'s at
   its precision, the expert rows equal to ``evaluate_expert`` on the
   CPU; each part's seconds.  Then ``evaluate_chain`` at the same shape,
   its stage-0 draw one ``native_reset`` launch, counted; that draw
   re-derived from ``key(0)`` (128 rows of NovelGridworld-v2) against the
   CPU's plain draw, and equal to the state the chain makes from the key
   with no stage to play.  Under
   ``NGX_DEBUG=1`` a facing of 5 after a Forward raises ngx's "facing in
   {0,1,2,3}" text on the card, and a plain step runs after it (the CUDA
   context survived); with the flag off the step from facing 5 under every
   action equals the CPU's.

Then the ``gym_novel_gridworlds`` drop-in surface (``ngx_torch.dropin``)
and the plain path on more than 32 item ids and on NOOP:

u. ``import ngx_torch.dropin`` in a subprocess with jax blocked, no ngx,
   jax or ``gym_novel_gridworlds`` module loaded; ``install(device=...)``
   on the card and then on the CPU, ``tests/_gym_shim`` on the path as the
   gym (the card's machine has none), and through ``gym_novel_gridworlds``:
   the 11 env classes and ``gym.make`` of the 11 ids, one random episode
   each (``numpy.random`` seeded, cap 100), the reference stack
   (``make`` -> ``LimitActions`` -> ``LidarInFront`` -> ``inject_novelty(
   'firewall', 'easy')``), the 16 novelty classes over Pogostick-v1
   (Bow-v1 for ``ExtractIncDec('increase')``) with 20 random actions each,
   ``remap_action_difficulty`` with and without a LimitActions below, and
   the v2 -> v3 restore-chaining constructor: every obs (value and dtype),
   reward, done and info on the card equal to the CPU's, and a facade
   step's ms on both.  Pogostick-v1 with 30 stacked additems (39 item ids)
   through the facade (one random episode) and, with a NOOP action,
   through ``make_vec`` (B 256, 100 random steps, cap 25), the card equal to
   the CPU; one ``make_train(..., 'auto')`` step on the 39-item spec (the
   acting kernel, pool resets; its draw and launch held against their
   twins on the same inputs, as in phase v) and ``throughput_fn`` on it
   (bit for bit against its twin); one ``make_train(...,
   rollout_backend='xla')`` step on it at B 8192, T 64 with finite
   losses.

Then the kernels over ngx's whole spec domain (the int16 map cell past 64
item ids, ``csrc/ngx_env.cuh`` wide_cell, and the NOOP op):

v. on phase u's 39-item spec, on Pogostick-v1 with 60 and 130 stacked
   additems and the wall replaced (70 and 140 item ids, ids past 63 and 127
   on the maps) and with Left as NOOP, under LidarInFront, B = 8192, T =
   64: 'input' and 'prng' against the twin and the pool draw (32,768
   resets at T 0) against ``reset_rows`` on the card, bit for bit; the
   train kernel with native resets (each env reset once, at step 0, 16, 32
   or 48; the 70 with fence medium on top, and the 140 also without its
   reset edits) and with pool resets (R 4, cap 10) by phase 3's rule;
   'policy' (hidden (64, 64)) on the 70, 140 and NOOP specs bit for bit
   against the train kernel with the cap off and within 1% of envs of its
   twin.  The last int8 and the first int16 spec (55 and 56 additems: 64
   and 65 item ids) through 'prng' and the native train kernel, held and
   timed side by side.  Then the main paths, counted, each launch held
   against its twin on the same inputs (the launches ``make_train`` makes
   copied as it makes them, then replayed through the twins, which launch
   nothing): ``make_train(PPOConfig(num_envs=8192), spec_override=<39-item
   spec>)`` with 'auto' for 3 steps (exactly 3 pool-mode launches and 3
   draws, finite losses), one step each on the 140 and on the 140 without
   reset edits (the int16 pool and native kernels), ``make_rollout``
   'input' on the 70 (bit for bit) and 'policy' on the 140 (equal to the
   held launch), and ``throughput_fn`` on the 70 at T = 1024 (bit for bit
   against its twin, and by CUDA events).  The phase's time is printed.

Then the tile kernels' reset phase (the train kernel and 'policy' hand
the envs a step finished to the block's warps, ``csrc/ngx_env.cuh``
tile_finish and warp_reset):

w. at B = 8192, T = 64, hidden (64, 64), each against its plain twin by
   phase 3's rule: the train kernel with cap 1 (every env of every tile
   resets on every step: native on Pogostick-v1, pool on fence medium),
   with cap 3 on v3 (the wall coin), Pogostick-v0 (the tap), fence hard
   stacked with an additem (two reset edits; native and pool) and
   Pogostick-v1 with 55 stacked additems (64 item ids, 55 edits), and on v3
   at B = 8100 in blocks of 450 (a ragged last tile); 'policy' on v3, the
   stacked fence and the 64-id spec and on v3 at B = 8100, each bit for bit
   against the train kernel from its ctr-0 state with the cap off and
   within 1% of envs of its twin; the native kernel's time at cap 1.  The
   phase's time is printed.

Then ngx's own seeded draws (``jax.random``'s threefry2x32 in torch,
``ngx_torch/ops/threefry.py``; plain torch on the card, but for the native
reset, one launch of ``csrc/native_reset.cu`` a call):

x. each run on the card and on the CPU from the same key, the count of
   differing rows 0: the threefry bits of 2^20 counters; Gumbel's
   ``-log(-log(u))`` strictly increasing over all 2^23 uniforms on the card
   (so a categorical over a 0 / -inf mask is the first maximal uniform, as
   on the CPU and in XLA); ``make_reset`` at B = 8192 on Pogostick-v1 and
   fence medium under LidarInFront, state and obs; ``throughput_fn(
   action_rng='threefry')`` at B = 8192, T = 64 on Pogostick-v1, final
   state and mean reward.  Its paths launch no rollout or train kernel,
   and the native reset kernel once a reset: once a ``make_reset`` call,
   and in ``throughput_fn`` once for the start and once a step.  The
   card's times (host clock after a
   synchronize), and the 'prng' kernel's ``throughput_fn`` at the same B
   and T beside them, are printed.

Then the PPO main path on ngx's keys against the CPU:

y. each on the card against the CPU from one key: ``permutation`` at n =
   B*T = 524288 (0 values differ); the keyed ``make_train`` init at B =
   8192 on Pogostick-v1 and fence medium (0 state and obs rows differ, the
   parameters 0 ulp apart: drawn on the host); 3 keyed ``make_train('auto')``
   steps on each (PPOConfig(num_envs=8192): T 64, hidden (64, 64), 4 x 8
   minibatches), run with the launch counts set to 0 and read after: 3
   native launches, or 3 pool launches and 3 pool draws, each held against
   its twin on the same inputs (phase v's ``_v_held``), every kernel seed,
   pool seed and epoch permutation equal to the host's derivation from the
   key, counted in the kernels line's ``paths``; the step's phases, and
   its synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode``) no
   more than the removed counter-RNG step made (4);
   the keyed 'xla' step at B = 1024 (cut from 8192 for the CPU side) by
   phase 3's rule (per env up to its first action mismatch, at most 1% of
   envs; the parameters within rtol 1e-5 / atol 1e-6 where none); keyed
   ``make_eval`` at 1024 episodes, the random policy's metrics equal and
   the Pogostick-v1 solver's within 1% of episodes.

Then the chain, the training CLI and the mesh's stepping on ngx's keys
(phase o's and q's CLI runs take ngx's key schedule, the CLI's only one):

z. each on the card against the CPU from one key: keyed
   ``make_chain_reset`` (NovelGridworld-v2 -> v5, the stage agents of
   ``trained_agents_torch/chain``, P = 1024, cap 100), its state and obs
   rows differing by at most 1% (a stage policy's Gumbel near-ties); 3
   keyed ``make_train_chain('auto')`` steps (PPOConfig(env_id=
   "NovelGridworld-v5", num_envs=8192, solve_shaped=True, bc_coef=0.05),
   T 64, R 4, the v5 demos as the BC anchor) run with the launch counts
   set to 0 and read after: exactly 3 pool-mode launches and no stage-0
   draw, each launch held against its twin on the same inputs (phase v's
   ``_v_held``), every kernel seed, pool row and epoch permutation equal
   to the CPU's derivation from the key, counted in the
   ``train_rollout:pool:chain`` row's ``paths``; the step by phase; one
   timed ``refresh_pool``; keyed ``evaluate_chain`` with chain_solver_v5
   at 1024 episodes (equal, or within 1% of episodes); keyed
   ``sharded_throughput_fn`` (state rows, mean and episodes) and
   ``make_spmd_rollout`` (mean and episodes; packed equal to plain) at W
   1, B = 8192, T = 16 on NovelGridworld-v3 (episodes end there);
   ``rl/scaling.py``'s ``measure_scaling((1, 2), 'fixed-total')`` (ranks
   spawned, gloo on one card, 8,192 envs in all, T = 64; each rank's keyed
   ``make_train(cfg, mesh)`` on ngx's step keys) printed, not gated, each
   rank's four acting launches counted.  The keyed paths other than the
   train step and the scaling harness launch no kernel.

Then the perf CLI on ngx's keys (``ngx_torch/cli/perf.py``, in process):

kp. ``perf --trainer -batch 8192 -repeats 1`` on Pogostick-v1 and with
   ``-novelty fence:medium:oak`` (ngx's schedule: ``init(key(0))``, the
   warm-up on ``key(1)``, the timed step on ``key(2)``, the by-phase step
   on ``key(3)``, T 64, both backends), each run with the launch counts
   set to 0 just before and read just after: the kernel side's 3 native,
   or 3 pool-mode launches and 3 pool draws, the unfused side none, each
   launch held against its twin on the same inputs (phase v's
   ``_v_held``); ``perf --policy -batch 8192 -steps 64 --no-twin`` (ngx's
   weights, ``ActorCritic.from_key(key(1))``), its 4 'policy' launches
   each against the twin on the same inputs (at most 1% of envs apart);
   counted in the kernels line's ``paths``.

The line before the last is the kernels' JSON record: per kernel its
launches on a main path (``paths`` has the count on each main path that
runs it), its error against the plain version, its time, the plain
version's, and ``bound_ms``, the larger of the bytes it must move over 3.35
TB/s and its float32 operations over 67 TFLOP/s (the H100 SXM's data-sheet
peaks; the env step's integer work is not counted); no PyTorch call
computes any of them, so ``library_ms`` is null.  The ``:wide`` rows are
the int16-cell instantiations that phase v launches, each timed on the
spec and shape of the path it names: 'input' on the 70-id spec, 'prng' as
``throughput_fn`` on the 70 at T = 1024, 'policy' and the pool kernel on
the 140, the native kernel on the 140 without reset edits, at B = 8192,
T = 64 where not said.  The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

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


# phase r: the sharded trainer and env stepping (ngx_torch.parallel)
SHARD_B, SHARD_T, R_STEPS = 65536, 1024, 3


def _r_spec(name):
    """Phase r's specs under LidarInFront: Pogostick-v1 ('native') or fence
    medium ('fence', phase f's)."""
    import numpy as np
    import ngx_torch as nt

    sp = nt.make_spec(POGO)
    if name == "fence":
        sp = nt.inject_novelty(sp, "fence", "medium", "oak",
                               rng=np.random.RandomState(0))
    return nt.lidar_in_front(sp)


def _digest(*tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _state_digest(st):
    return _digest(*(getattr(st, f) for f in st.__dataclass_fields__))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _r_perms(u, rank, n, epochs):
    """The permutations injected at step ``u`` of ``rank`` (W 1 and the
    unsharded step get the same)."""
    import torch

    g = torch.Generator().manual_seed(1000 * u + rank)
    return [torch.randperm(n, generator=g) for _ in range(epochs)]


def _r_train(mesh, name, device, inject, keep_carry=False):
    """R_STEPS make_train steps on ``name`` at B 8,192 through the kernel,
    over ``mesh`` (None: unsharded on ``device``), from ``key(SEED)`` and
    step ``u`` on ``fold_in(key, u + 1)``; with ``inject`` the trainer's
    ``epoch_perms`` gives _r_perms' permutations for the step (else the
    rank's own keyed draws: under a mesh ``fold_in(k_upd, rank)``, so W 1
    and the unsharded step share them only when injected).  Per step: the
    digests of the state, the last obs and the trajectory, the flat
    parameters, the global metrics, the rank's collectives, the seconds;
    with ``keep_carry``, copies of the state and the policy tower after the
    step (the next step's acting inputs) as ``carry``."""
    import torch
    from ngx_torch.ops import threefry as TF
    from ngx_torch.rl import train as TRN

    cfg = TRN.PPOConfig(num_envs=B, rollout_steps=T)
    init, step = TRN.make_train(cfg, mesh, spec_override=_r_spec(name),
                                rollout_backend="pallas", device=device)
    step.keep_rollout = True
    key = TF.key(SEED)
    carry = init(key)
    rank = 0 if mesh is None else mesh.rank
    n = T * B // (1 if mesh is None else mesh.size)
    dev = carry[1].device
    steps = []
    keyed_perms = TRN.epoch_perms
    for u in range(R_STEPS):
        if inject:
            perms = [p.to(dev) for p in _r_perms(u, rank, n, cfg.epochs)]
            TRN.epoch_perms = lambda *a, perms=perms: perms
        log = [] if mesh is None else mesh.log
        log.clear()
        _sync(dev)
        t0 = time.perf_counter()
        try:
            carry, m = step(carry, TF.fold_in(key, u + 1))
        finally:
            TRN.epoch_perms = keyed_perms
        _sync(dev)
        secs = time.perf_counter() - t0
        steps.append({
            "state": _state_digest(carry[1]), "last_obs": _digest(carry[2]),
            "rollout": _digest(*step.rollout),
            "params": torch.cat([p.detach().reshape(-1) for p in
                                 carry[0].model.parameters()]).cpu().numpy(),
            "metrics": {k: float(v) for k, v in m.items()},
            "collectives": list(log),
            "secs": secs})
        if keep_carry:
            st = carry[1]
            steps[-1]["carry"] = (
                type(st)(**{f: getattr(st, f).clone()
                            for f in st.__dataclass_fields__}),
                [(w.detach().clone(), b.detach().clone())
                 for w, b in carry[0].model.pi_layers()])
    return steps


def _r_stepping(mesh):
    """sharded_throughput_fn and make_spmd_rollout (plain and packed) on
    Pogostick-v1 at SHARD_B x SHARD_T over ``mesh``: the rank's state
    digest, the global metrics, each call's host ms ending in a
    synchronize, the launches and the collectives."""
    import ngx_torch as nt
    from ngx_torch import parallel as P
    from ngx_torch.ops import rollout as RO

    spec = nt.make_spec(POGO)
    fns = {"sharded_throughput_fn": P.sharded_throughput_fn(
               spec, mesh, SHARD_B, SHARD_T),
           "make_spmd_rollout": P.make_spmd_rollout(spec, mesh, SHARD_B,
                                                    SHARD_T),
           "make_spmd_rollout(packed)": P.make_spmd_rollout(
               spec, mesh, SHARD_B, SHARD_T, packed=True)}
    RO.rollout.launches.update(dict.fromkeys(RO.rollout.launches, 0))
    mesh.log.clear()
    res = {}
    for name, fn in fns.items():
        _sync(mesh.device)
        t0 = time.perf_counter()
        out = fn(SEED)
        _sync(mesh.device)
        res[name] = {"mean": float(out[-2]), "episodes": int(out[-1]),
                     "ms": (time.perf_counter() - t0) * 1e3}
        if len(out) == 3:
            res[name]["state"] = _state_digest(out[0])
    res["launches"] = dict(RO.rollout.launches)
    res["collectives"] = list(mesh.log)
    return res


def _r_rank(mesh):
    """One of phase r's two ranks on one card (gloo over CUDA tensors): the
    trainer on both specs, counted, then the sharded env stepping."""
    from ngx_torch.ops import rollout as RO
    from ngx_torch.ops import train_rollout as TR

    out = {}
    for name in ("native", "fence"):
        TR.train_rollout.launches.update(native=0, pool=0)
        RO.pool_reset.launches = 0
        out[name] = _r_train(mesh, name, mesh.device, inject=False)
        out[name + ":launches"] = dict(TR.train_rollout.launches,
                                       pools=RO.pool_reset.launches)
    out["stepping"] = _r_stepping(mesh)
    return out


def _r_twin_check(tag, spec, out_k, state, layers, seed, block, cap, pool,
                  base):
    """Phase 3's rule for one rank's shard: the plain twin on CPU copies of
    the kernel's inputs (``state``, ``layers``, the shard ``seed``, the
    rank's ``pool`` rows and ``base``, ``cap``) against the kernel's rollout
    ``out_k``: everything equal per env up to its first action mismatch,
    at most MAX_MISMATCH_SHARE of envs with one, each at a Gumbel near-tie,
    and an episode boundary inside.  Returns the max |err| in the compared
    prefix."""
    import torch
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams

    cpu = torch.device("cpu")
    n = state.batch
    out_p = TR.train_rollout_plain(
        spec, state.to(cpu), [(w.cpu(), b.cpu()) for w, b in layers], seed,
        T, block=block, cap=cap,
        pool=None if pool is None else pool.to(cpu),
        base=None if base is None else base.cpu())
    out_k = tuple(x.to(cpu) for x in out_k)
    first, bad = TR.compare_rollouts(out_k, out_p)
    if bad:
        fail(f"{tag}: kernel and plain twin disagree inside the compared "
             f"prefix: {bad}")
    mism = (first < T).nonzero()[:, 0]
    seeds, rows = block_streams(seed, n, block, cpu)
    max_gap = 0.0
    cpu_layers = [(w.cpu(), b.cpu()) for w, b in layers]
    for b in mism.tolist():
        t = int(first[b])
        score = TR.gumbel_scores(TR.mlp_logits(out_p[1][t, b][None],
                                               cpu_layers),
                                 seeds[b:b + 1], t + 1, rows[b:b + 1])
        top2 = torch.topk(score[0], 2).values
        max_gap = max(max_gap, float(top2[0] - top2[1]))
    steps = torch.arange(T)[:, None]
    err_obs = ((out_k[1] - out_p[1]).abs().amax(-1)
               * (steps <= first[None, :])).amax()
    err_rew = ((out_k[3] - out_p[3]).abs() * (steps < first[None, :])).amax()
    max_abs_err = float(torch.maximum(err_obs, err_rew))
    n_done = int(out_k[4].sum())
    print(f"{tag} kernel vs the plain twin on the CPU at B={n} T={T} "
          f"block={block}: {n_done} dones, {mism.numel()} envs with an "
          f"action mismatch ({mism.numel() / n:.5%}), top-2 Gumbel gap at "
          f"a mismatch <= {max_gap:.3g}, max |err| in the compared prefix "
          f"{max_abs_err}")
    if n_done == 0:
        fail(f"{tag}: no episode boundary inside the compared rollout")
    if mism.numel() / n > MAX_MISMATCH_SHARE:
        fail(f"{tag}: {mism.numel() / n:.3%} of envs mismatch the twin")
    if max_gap >= GUMBEL_TIE_GAP:
        fail(f"{tag}: an action mismatch at a Gumbel gap of {max_gap}")
    return max_abs_err


def _phase_r(dev, smi, w1_backend="nccl"):
    """Phase r (module docstring) on ``dev``; returns each sharded main
    path's launches, W 1's env-stepping record, the two ranks' and, by
    spec, the largest |err| of a rank's acting launch against the plain
    twin."""
    import threading

    import numpy as np
    import torch
    import torch.distributed as dist

    import ngx_torch as nt
    from ngx_torch import parallel as P
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops.tables import seed_i32
    from ngx_torch.rl.train import (PPOConfig, draw_seed, make_train,
                                    pick_trainer_block)
    from ngx_torch.vector import throughput_fn

    pogo = nt.make_spec(POGO)

    def same_steps(tag, got, want, params_exact=True):
        """Phase r's per-step records equal: digests and metrics exactly,
        the parameters bit for bit (or, with ``params_exact`` False,
        within rtol 1e-5 / atol 1e-6); returns the largest |param diff|."""
        worst = 0.0
        for u, (g, w) in enumerate(zip(got, want)):
            for k in ("state", "last_obs", "rollout"):
                if g[k] != w[k]:
                    fail(f"{tag}: step {u} {k} differs")
            diff = np.abs(g["params"] - w["params"])
            worst = max(worst, float(diff.max()))
            if params_exact and worst:
                fail(f"{tag}: step {u} parameters differ by {worst}")
            if not (diff <= 1e-6 + 1e-5 * np.abs(w["params"])).all():
                fail(f"{tag}: step {u} parameters differ by {worst}")
            for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum",
                      "mean_reward"):
                if g["metrics"][k] != w["metrics"][k]:
                    fail(f"{tag}: step {u} {k} {g['metrics'][k]} != "
                         f"{w['metrics'][k]}")
        return worst

    def stepping_twin(W):
        """The global metrics of the W-shard env stepping, each shard
        through the kernel with its seed and block, the float32 shard sums
        added in rank order in float64; and the unsharded state's digest
        by rows of each shard."""
        loc = SHARD_B // W
        sums, eps = 0.0, 0
        for k in range(W):
            _, rsum, dcount = R.rollout(
                pogo, loc, SHARD_T, seed_i32(SEED + k * loc // 512 * 7919),
                512, "prng", device=dev)
            sums += float(rsum.sum())
            eps += int(dcount.sum())
        full, _ = throughput_fn(pogo, SHARD_B, SHARD_T, device=dev)(SEED)
        digests = [_state_digest(full.take(slice(k * loc, (k + 1) * loc)))
                   for k in range(W)]
        return float(np.float32(sums / (SHARD_B * SHARD_T))), eps, digests

    def check_stepping(tag, res, W, rank, twin):
        mean, eps, digests = twin
        if res["sharded_throughput_fn"]["state"] != digests[rank]:
            fail(f"{tag}: rank {rank}'s state is not its rows of the "
                 "unsharded throughput_fn's")
        for name in ("sharded_throughput_fn", "make_spmd_rollout",
                     "make_spmd_rollout(packed)"):
            got = (res[name]["mean"], res[name]["episodes"])
            if got != (mean, eps):
                fail(f"{tag}: {name} {got} != the twin's {(mean, eps)}")
        want = {"prng": 2, "prng:packed": 1}
        if {k: v for k, v in res["launches"].items() if v} != want:
            fail(f"{tag}: launches {res['launches']} (expected {want})")
        if res["collectives"] != [("all_reduce", "metrics", 16)] * 3:
            fail(f"{tag}: collectives {res['collectives']}")
        print(f"[r] {smi}: {tag} rank {rank} of {W}, B={SHARD_B} "
              f"T={SHARD_T}: " + ", ".join(
                  f"{n} {res[n]['ms']:.4f} ms (host clock)" for n in (
                      "sharded_throughput_fn", "make_spmd_rollout",
                      "make_spmd_rollout(packed)"))
              + f"; mean {mean}, episodes {eps}")

    # W 1: rank 0 of 1 in this process, NCCL on the card.  The main paths,
    # each counted from 0 just before it and read just after
    r_paths = {}
    t_r = time.perf_counter()
    backend = P.initialize_distributed(f"localhost:{P._free_port()}", 1, 0,
                                       backend=w1_backend, device=dev)
    try:
        mesh1 = P.make_env_mesh(device=dev)
        print(f"[r] W 1: rank {mesh1.rank} of {mesh1.size}, {backend} on "
              f"{mesh1.device}")
        w1 = {}
        for name in ("native", "fence"):
            TR.train_rollout.launches.update(native=0, pool=0)
            R.pool_reset.launches = 0
            w1[name] = _r_train(mesh1, name, dev, inject=True)
            r_paths[name, "W1"] = dict(TR.train_rollout.launches,
                                       pools=R.pool_reset.launches)
        w1_step = _r_stepping(mesh1)
    finally:
        dist.destroy_process_group()
    for name in ("native", "fence"):
        mode = "pool" if name == "fence" else "native"
        got = r_paths[name, "W1"]
        if got[mode] != R_STEPS or sum(got.values()) != R_STEPS * (
                2 if mode == "pool" else 1):
            fail(f"[r] W 1 {name}: launches {got} in {R_STEPS} steps")
        worst = same_steps(f"[r] W 1 {name} vs the unsharded step",
                           w1[name], _r_train(None, name, dev, inject=True),
                           params_exact=False)
        print(f"[r] {smi}: W 1 {name}: state, last obs, trajectory and "
              f"counts equal the unsharded make_train's in {R_STEPS} steps; "
              f"largest |param diff| {worst:.3e} (ngx's mesh moments, not "
              f"adv.std()); launches {got}; step seconds "
              f"{['%.6f' % x['secs'] for x in w1[name]]}")
    check_stepping("W 1 (nccl)", w1_step, 1, 0, stepping_twin(1))

    # W 2: two processes on the one card, gloo over CUDA tensors
    t0 = time.perf_counter()
    w2 = P.spawn_ranks(_r_rank, 2, device=dev.type, backend="gloo",
                       timeout=600)
    spawn_s = time.perf_counter() - t0
    twin = {}
    meshes = P.make_local_meshes(2, dev)
    for name in ("native", "fence"):
        out = [None, None]

        def thread(mesh):
            out[mesh.rank] = _r_train(mesh, name, dev, inject=False,
                                      keep_carry=True)

        threads = [threading.Thread(target=thread, args=(m,)) for m in meshes]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        twin[name] = out
    init_u, _ = make_train(PPOConfig(num_envs=B, rollout_steps=T), device=dev)
    twin_err = {}
    for name in ("native", "fence"):
        spec_r = _r_spec(name)
        for k in range(2):
            got = w2[k][name]
            same_steps(f"[r] W 2 {name} rank {k} vs the in-process twin",
                       got, twin[name][k])
            if any(np.any(a["params"] != b["params"])
                   for a, b in zip(got, w2[1 - k][name])):
                fail(f"[r] W 2 {name}: the ranks' parameters differ")
            launches_k = w2[k][name + ":launches"]
            r_paths[name, f"W2 rank {k}"] = launches_k
            mode = "pool" if name == "fence" else "native"
            if launches_k[mode] != R_STEPS:
                fail(f"[r] W 2 {name} rank {k}: launches {launches_k}")
        # each shard's acting at steps 1 and 2 against the kernel on that
        # shard's inputs: step 1 from the init, step 2 from the twin's carry
        # after step 1 (the rank's, bit for bit, as just checked); step 2,
        # where the cap of 100 ends every episode, also against the plain
        # twin on CPU copies (step 1 from fresh episode clocks has no
        # boundary to check)
        ts_u, st_u, _, _ = init_u(TF.key(SEED)) if name == "native" else \
            make_train(PPOConfig(num_envs=B, rollout_steps=T),
                       spec_override=spec_r, device=dev)[0](TF.key(SEED))
        for u in range(2):
            # the step's seeds, re-derived from its key as the trainer
            # draws them: k_roll, k_upd = split(key_u); in pool mode
            # k_seed, k_pool = split(k_roll)
            k_roll, _ = TF.split(TF.fold_in(TF.key(SEED), u + 1))
            pool_r = None
            if name == "fence":
                k_roll, k_pool = TF.split(k_roll)
                pool_r = R.pool_reset(spec_r, B * POOL_R, draw_seed(k_pool),
                                      device=dev)
            roll = draw_seed(k_roll)
            for k in range(2):
                lo, hi = k * B // 2, (k + 1) * B // 2
                if u == 0:
                    state = st_u.take(slice(lo, hi))
                    layers = [(w.detach(), b.detach()) for w, b in
                              ts_u.model.pi_layers()]
                else:
                    state, layers = twin[name][k][0]["carry"]
                shard = dict(
                    state=state, layers=layers, seed=P.shard_seed(roll, k),
                    block=pick_trainer_block(B // 2),
                    cap=PPOConfig().episode_cap,
                    pool=None if pool_r is None else pool_r.take(
                        slice(lo * POOL_R, hi * POOL_R)),
                    base=None if pool_r is None else torch.zeros(
                        (B // 2,), dtype=torch.int32, device=dev))
                out = TR.train_rollout(
                    spec_r, shard["state"], shard["layers"], shard["seed"],
                    T, block=shard["block"], cap=shard["cap"],
                    pool=shard["pool"], base=shard["base"])
                if (_digest(*out[1:5]), _state_digest(out[0])) != (
                        w2[k][name][u]["rollout"], w2[k][name][u]["state"]):
                    fail(f"[r] W 2 {name} rank {k}: step {u + 1}'s acting "
                         "is not the kernel's on its shard")
                if u == 1:
                    twin_err[name] = max(twin_err.get(name, 0.0),
                                         _r_twin_check(
                        f"[r] W 2 {name} rank {k} step 2", spec_r, out,
                        **shard))
        print(f"[r] {smi}: W 2 {name}: each rank's acting equals the "
              f"kernel on its shard, which agrees with the plain twin; "
              f"parameters equal on both ranks and the "
              f"in-process twin's bit for bit in {R_STEPS} steps; step "
              f"seconds rank 0 {['%.6f' % x['secs'] for x in w2[0][name]]}"
              f", rank 1 {['%.6f' % x['secs'] for x in w2[1][name]]}")
    tw2 = stepping_twin(2)
    for k in range(2):
        check_stepping("W 2 (gloo, one card)", w2[k]["stepping"], 2, k, tw2)
    # the collectives of a step: rank 0, step 1 on Pogostick-v1
    log = w2[0]["native"][0]["collectives"]
    nparams = w2[0]["native"][0]["params"].size
    by_tag = {}
    for op, tag, n in log:
        by_tag.setdefault((op, tag), []).append(n)
    total = sum(n for _, _, n in log)
    print(f"[r] {smi}: collectives of one train step (W 2, B={B}, T={T}, "
          f"{nparams} parameters): " + "; ".join(
              f"{len(v)} x {op} {tag} {sorted(set(v))} bytes"
              for (op, tag), v in by_tag.items()) + f"; {total} bytes in all")
    n_mb = PPOConfig().epochs * PPOConfig().num_minibatches
    if {op for op, _, _ in log} != {"all_reduce"} or \
            by_tag.get(("all_reduce", "grad")) != [4 * nparams] * n_mb or \
            len(by_tag.get(("all_reduce", "moments"), [])) != n_mb or \
            len(by_tag.get(("all_reduce", "metrics"), [])) != 1:
        fail(f"[r] the collectives of a step are not the expected ones: "
             f"{by_tag}")
    print(f"[r] {smi}: W 2: two ranks spawned, run and joined in "
          f"{spawn_s:.3f} s")
    print(f"[r] {smi}: phase r took {time.perf_counter() - t_r:.3f} s "
          "(phase timer, host clock)")

    return r_paths, w1_step, w2, twin_err


# phase s: the single-env facade and its drivers (ngx_torch.compat)
S_EPISODES, S_CAP, S_EVAL_EPISODES = 4, 100, 128
S_POLICY_STEPS = 200
S_LIMITED = ("Forward", "Left", "Right", "Break", "Craft_plank",
             "Craft_stick", "Select_tree_log")
# dagger's cuts, beside ngx's defaults (ngx/cli/dagger.py:91-94)
S_DAGGER = {"-rounds": (2, 8), "-episodes_per_round": (16, 64),
            "-bc_steps": (500, 4000), "-sharpen": ("1,2", "1,2,4,8")}


def _s_same(a, b):
    """Equal values of equal types: numpy arrays also by dtype and shape."""
    import numpy as np

    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(_s_same(a[k], b[k]) for k in b))
    if isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_s_same(x, y) for x, y in zip(a, b)))
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and bool((a == b).all()))
    return type(a) is type(b) and a == b


def _s_play(make_env, device, seed, episodes=S_EPISODES, cap=S_CAP,
            on_state=None):
    """``episodes`` random-action episodes of at most ``cap`` steps on a
    facade made on ``device``: the trace of every reset and step, and the
    steps.  ``on_state(env)`` is called after each reset and step."""
    import numpy as np

    np.random.seed(seed)
    env = make_env(device)
    rng = np.random.RandomState(seed + 1)
    trace, steps = [], 0
    for ep in range(episodes):
        np.random.seed(seed * 10 + ep)
        trace.append(env.reset())
        if on_state:
            on_state(env)
        for _ in range(cap):
            out = env.step(int(rng.randint(env.action_space.n)))
            trace.append(out)
            if on_state:
                on_state(env)
            steps += 1
            if out[2]:
                break
    return trace, steps


def _s_chain(device):
    """The reference's restore chain v1 -> v2 -> v3 -> v4 -> v3
    (enjoy.py:58-100) with random actions: its trace and steps."""
    import numpy as np

    import ngx_torch.compat as TC

    prev, trace, steps = None, [], 0
    rng = np.random.RandomState(5)
    for stage, env_id in enumerate(("NovelGridworld-v1", "NovelGridworld-v2",
                                    "NovelGridworld-v3", "NovelGridworld-v4",
                                    "NovelGridworld-v3")):
        env = TC.make(env_id, env=prev, device=device)
        np.random.seed(100 + stage)
        trace.append(env.reset())
        for _ in range(30):
            out = env.step(int(rng.randint(env.action_space.n)))
            trace.append(out)
            steps += 1
            if out[2]:
                break
        trace.append((env.map.copy(), env.inventory_items_quantity))
        prev = env
    return trace, steps


@contextlib.contextmanager
def _s_policy_trace(buf):
    """Record every policy draw of the drivers (``enjoy.Policy.__call__``,
    ngx's ``policy(key, obs)``) made inside the block: ``(key, logits,
    action, lines printed to buf so far)`` each."""
    from ngx_torch.cli import enjoy

    real, trace = enjoy.Policy.__call__, []

    def call(self, key, obs):
        logits = self.logits(obs)
        a = real(self, key, obs)
        trace.append((key.clone(), logits, a,
                      len(buf.getvalue().splitlines())))
        return a

    enjoy.Policy.__call__ = call
    try:
        yield trace
    finally:
        enjoy.Policy.__call__ = real


def _s_first_mismatch(tag, card, host):
    """The drivers' first-mismatch rule over two policy traces
    (:func:`_s_policy_trace`), the card's and the CPU's: the same keys and
    actions up to the first action that differs, which must sit at a
    near-tie of the CPU's Gumbel scores (gap under GUMBEL_TIE_GAP); nothing
    is compared after it.  Returns ``(index of the first mismatch or None,
    its gap, max |logit diff| before it)``."""
    import torch

    from ngx_torch.ops import threefry as TF

    first, err = None, 0.0
    for i, (c, h) in enumerate(zip(card, host)):
        if not torch.equal(c[0], h[0]):
            fail(f"{tag}: policy draw {i} takes another key on the card")
        if c[2] != h[2]:
            first = i
            break
        err = max(err, float((c[1] - h[1]).abs().max()))
    if first is None:
        if len(card) != len(host):
            fail(f"{tag}: {len(card)} policy draws on the card, "
                 f"{len(host)} on the CPU, with no action apart")
        return None, 0.0, err
    key, logits, a_h = host[first][:3]
    score = TF.gumbel(key, tuple(logits.shape)) + logits
    gap = float(score[a_h] - score[card[first][2]])
    if gap >= GUMBEL_TIE_GAP:
        fail(f"{tag}: the card's action at policy draw {first} differs from "
             f"the CPU's at a Gumbel gap of {gap} (not a tie)")
    return first, gap, err


def _s_round_rows(text):
    """dagger's printed round lines as ``(round, dataset, bc_acc, solve,
    return, tau)``."""
    rows = []
    for line in text.splitlines():
        m = re.match(r"round (\d+): dataset=(\d+) bc_acc=([\d.]+)% "
                     r"solve=([\d.]+)% return=(-?[\d.]+) \(tau=([\d.]+)\)",
                     line)
        if m:
            rows.append(tuple(float(x) for x in m.groups()))
    return rows


def _phase_s(dev, smi):
    """Phase s (module docstring) on ``dev``: the facade on the card
    against the CPU, ``evaluate_expert``, the SB2 path and the drivers;
    every check fatal."""
    import contextlib
    import io
    import zipfile

    import numpy as np
    import torch

    import ngx_torch as nt
    import ngx_torch.compat as TC
    from ngx_torch.cli import dagger, enjoy, record_demos
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops.rng import block_streams
    from ngx_torch.ops.train_rollout import gumbel_argmax
    from ngx_torch.rl.evaluate import evaluate_expert, evaluate_sb2_zip
    from ngx_torch.rl.sb2 import load_sb2_params, sb2_apply, sb2_to_device

    t_s = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    solver = os.path.join(root, "trained_agents_torch", f"{POGO}_solver",
                          "best.pt")
    quiet = contextlib.redirect_stdout

    # ---- 1. the facade, card against CPU ----------------------------------
    cases = {e: (lambda d, e=e: TC.make(e, device=d))
             for e in sorted(nt.SPEC_BUILDERS)}
    cases["LidarInFront(Pogostick-v1)"] = \
        lambda d: TC.LidarInFront(TC.make(POGO, device=d))
    cases["fence medium"] = lambda d: TC.inject_novelty(
        TC.make(POGO, device=d), "fence", "medium", "oak")
    cases["LimitActions(Pogostick-v1)"] = \
        lambda d: TC.LimitActions(TC.make(POGO, device=d), S_LIMITED)
    secs = {"cuda": 0.0, "cpu": 0.0}
    n_steps = 0
    for i, (name, make_env) in enumerate(cases.items()):
        traces = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            traces[d], steps = _s_play(make_env, d if d == "cpu" else dev,
                                       SEED % 1000 + i)
            secs[d] += time.perf_counter() - t0
        if not _s_same(traces["cuda"], traces["cpu"]):
            fail(f"phase s: the facade on {name} differs between the card "
                 "and the CPU")
        n_steps += steps
    buf = io.StringIO()
    with quiet(buf):
        t0 = time.perf_counter()
        chain_cuda, chain_steps = _s_chain(dev)
        secs["cuda"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        chain_cpu, _ = _s_chain("cpu")
        secs["cpu"] += time.perf_counter() - t0
    if not _s_same(chain_cuda, chain_cpu):
        fail("phase s: the restore chain differs between the card and the "
             "CPU")
    if buf.getvalue().count("RESTORING LAST ENV ...") != 8:
        fail("phase s: the restore chain did not restore 4 times a device")
    n_steps += chain_steps
    print(f"[s] {smi}: the facade on {len(cases)} envs x {S_EPISODES} "
          f"random episodes (cap {S_CAP}) and the v1 -> v3 restore chain, "
          f"{n_steps} steps a device: obs (values, dtypes), rewards, dones "
          f"and infos equal on the card and the CPU; card {secs['cuda']:.3f} "
          f"s ({secs['cuda'] / n_steps * 1e3:.4f} ms a facade step, host "
          f"clock), CPU {secs['cpu']:.3f} s "
          f"({secs['cpu'] / n_steps * 1e3:.4f} ms)")

    # ---- 2. evaluate_expert -------------------------------------------------
    secs = {"cuda": 0.0, "cpu": 0.0}
    n_steps = 0
    for env_id in sorted(nt.SPEC_BUILDERS):
        eps = S_EVAL_EPISODES if env_id == POGO else 8
        got = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[d] = evaluate_expert(env_id, episodes=eps, cap=S_CAP,
                                     device=dev if d == "cuda" else "cpu")
            secs[d] += time.perf_counter() - t0
        if got["cuda"] != got["cpu"]:
            fail(f"phase s: evaluate_expert({env_id}) card {got['cuda']} "
                 f"against CPU {got['cpu']}")
        n_steps += round(got["cuda"]["mean_length"] * eps)
        if env_id == POGO:
            print(f"[s] {smi}: evaluate_expert({POGO}, {eps} episodes, cap "
                  f"{S_CAP}) = {got['cuda']} on both devices")
    print(f"[s] {smi}: evaluate_expert on the 11 envs ({POGO} at "
          f"{S_EVAL_EPISODES} episodes, the others at 8), {n_steps} facade "
          f"steps a device, dicts equal; card {secs['cuda']:.3f} s "
          f"({secs['cuda'] / n_steps * 1e3:.4f} ms a step with the expert), "
          f"CPU {secs['cpu']:.3f} s ({secs['cpu'] / n_steps * 1e3:.4f} ms)")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 3. SB2 -------------------------------------------------------
        rng = np.random.RandomState(SEED % 1000)
        arrays = {}
        for tower, head, out in (("pi", "pi", 3), ("vf", "vf", 1)):
            dims = (10, 64, 64)
            for i in range(2):
                arrays[f"model/{tower}_fc{i}/w:0"] = rng.normal(
                    0, 0.3, dims[i:i + 2])
                arrays[f"model/{tower}_fc{i}/b:0"] = rng.normal(
                    0, 0.1, dims[i + 1])
            arrays[f"model/{head}/w:0"] = rng.normal(0, 0.3, (64, out))
            arrays[f"model/{head}/b:0"] = rng.normal(0, 0.1, out)
        npz = io.BytesIO()
        np.savez(npz, **{k: v.astype(np.float32) for k, v in arrays.items()})
        zip_path = os.path.join(tmp, "NovelGridworld-v0.zip")
        with zipfile.ZipFile(zip_path, "w") as z:
            z.writestr("parameters", npz.getvalue())
        params = load_sb2_params(zip_path)
        obs = torch.as_tensor(rng.uniform(0, 10, (S_EVAL_EPISODES, 10)),
                              dtype=torch.float32)
        cpu_out = sb2_apply(params, obs)
        card_out = sb2_apply(sb2_to_device(params, dev), obs.to(dev))
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(card_out, cpu_out))
        for a, b in zip(card_out, cpu_out):
            if not torch.allclose(a.cpu(), b, rtol=1e-6, atol=1e-6):
                fail(f"phase s: sb2_apply on the card against the CPU: max "
                     f"|err| {err}")
        t0 = time.perf_counter()
        m = evaluate_sb2_zip("NovelGridworld-v0", zip_path,
                             episodes=S_EVAL_EPISODES, cap=S_CAP, device=dev)
        sb2_s = time.perf_counter() - t0
        if not (0 <= m["solve_rate"] <= m["done_rate"] <= 1
                and 1 <= m["mean_length"] <= S_CAP):
            fail(f"phase s: evaluate_sb2_zip's metrics {m}")
        print(f"[s] {smi}: sb2_apply on the card against the CPU at "
              f"[{S_EVAL_EPISODES}, 10]: max |err| {err} (rtol 1e-6, atol "
              f"1e-6); evaluate_sb2_zip("
              f"NovelGridworld-v0, a seeded zip, {S_EVAL_EPISODES} episodes) "
              f"on the card: {m}, {sb2_s:.3f} s")

        # ---- 4. the drivers on ngx's keys, the card against the CPU ---------
        def run(tag, main, argv):
            """``main(argv(device))`` on the card, then on the CPU: per
            device its output, policy trace, result and seconds."""
            got = []
            for d in (dev, torch.device("cpu")):
                out = io.StringIO()
                t0 = time.perf_counter()
                with quiet(out), _s_policy_trace(out) as trace:
                    res = main(argv(d) + ["-device", str(d)])
                got.append((out.getvalue(), trace, res,
                            time.perf_counter() - t0))
            (out_c, tr_c, _, s_c), (out_h, _, _, s_h) = got
            tail = out_c.strip().splitlines()[-1:]
            print(f"[s] {smi}: {tag}: card {s_c:.3f} s, CPU {s_h:.3f} s, "
                  f"{len(tr_c)} policy draws on ngx's keys; {tail}")
            return got

        def hold_transcript(tag, got):
            """The printed episodes by the first-mismatch rule: equal, or
            equal up to the episode of the first action apart."""
            (out_c, tr_c, _, _), (out_h, tr_h, _, _) = got
            first, gap, err = _s_first_mismatch(tag, tr_c, tr_h)
            lines_c, lines_h = out_c.splitlines(), out_h.splitlines()
            upto = len(lines_h) if first is None else tr_h[first][3]
            if lines_c[:upto] != lines_h[:upto] or (
                    first is None and lines_c != lines_h):
                fail(f"{tag}: the card's transcript differs from the CPU's "
                     "before any action apart")
            print(f"[s] {tag}: transcript on the card equal to the CPU's "
                  + ("line for line" if first is None else
                     f"up to policy draw {first}, an action apart at a "
                     f"Gumbel gap of {gap:.3g}")
                  + f"; logits max |diff| {err:.3g} before it")
            return first

        # the keyed policy step at B 1 against the counter draw it replaced
        t0 = time.perf_counter()
        n_draw = S_POLICY_STEPS
        key, logits = TF.key(SEED % 1000), torch.zeros(nt.lidar_in_front(
            nt.make_spec(POGO)).n_actions)
        for _ in range(n_draw):
            key, k = TF.split(key)
            TF.categorical(k, logits)
        draw_ms = (time.perf_counter() - t0) * 1e3 / n_draw
        step_ms = {}
        for form in ("keyed", "counter", "none"):
            env = TC.LidarInFront(TC.make(POGO, device=dev))
            pol = enjoy.load_policy(solver, env.spec, dev)
            seeds, rows = block_streams(SEED % 1000, 1, 1, dev)
            np.random.seed(SEED % 1000)
            obs, key = env.reset(), TF.key(SEED % 1000)
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(n_draw):
                if form == "keyed":
                    key, k = TF.split(key)
                    a = pol(k, obs)
                elif form == "counter":
                    # the kernels' Gumbel-argmax (salt 5, ctr i + 1)
                    o = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                        device=dev)
                    with torch.no_grad():
                        a = int(gumbel_argmax(pol.logits_fn(o), seeds, i + 1,
                                              rows)[0])
                else:
                    a = i % env.action_space.n
                obs, _, done, _ = env.step(a)
                if done:
                    obs = env.reset()
            step_ms[form] = (time.perf_counter() - t0) * 1e3 / n_draw
        print(f"[s] {smi}: a facade step of LidarInFront({POGO}) with the "
              f"solver's draw on {dev}, {n_draw} steps (host clock): keyed "
              f"(split and categorical on the host) {step_ms['keyed']:.4f} "
              f"ms, counter (the Gumbel-argmax on the device) "
              f"{step_ms['counter']:.4f} ms, no policy "
              f"{step_ms['none']:.4f} ms; the host's split and categorical "
              f"alone {draw_ms:.4f} ms a draw")

        tag = f"enjoy {POGO} (the solver, 8 episodes, ngx's keys)"
        got = run(tag, enjoy.main, lambda d: [
            "-env", POGO, "-episodes", "8", "-ckpt", solver])
        hold_transcript(tag, got)
        if got[0][0].count("episode ") != 8:
            fail("phase s: enjoy did not play 8 episodes")
        tag = ("enjoy NovelGridworld-v5 -ckpt trained_agents_torch/chain "
               "(ngx's keys)")
        got = run(tag, enjoy.main, lambda d: [
            "-env", "NovelGridworld-v5", "-ckpt",
            os.path.join(root, "trained_agents_torch", "chain")])
        hold_transcript(tag, got)
        out = got[0][0]
        if out.count("--- stage") != 5 or out.count("RESTORING") != 4:
            fail("phase s: enjoy's v5 chain did not play its 5 stages")
        for policy in ("expert", "ckpt"):
            tag = f"record_demos -policy {policy}"
            got = run(tag, record_demos.main, lambda d: [
                "-env", POGO, "-episodes", "4", "-policy", policy, "-ckpt",
                solver, "-out", os.path.join(tmp, f"{policy}-{d.type}.npz")])
            first, gap, _ = _s_first_mismatch(tag, got[0][1], got[1][1])
            files = [np.load(os.path.join(tmp, f"{policy}-{d}.npz"))
                     for d in (dev.type, "cpu")]
            z, zh = (dict(f) for f in files)
            for f in files:
                f.close()
            n = z["obs"].shape[0]
            layout = {k: (z[k].dtype.str, z[k].shape) for k in z}
            want = {"actions": ("<i8", (n, 1)),
                    "episode_returns": ("<f8", (4,)),
                    "rewards": ("<f8", (n,)),
                    "obs": ("<f8", (n, 63)),
                    "episode_starts": ("|b1", (n,))}
            if (layout != want or int(z["episode_starts"].sum()) != 4
                    or not np.isclose(z["rewards"].sum(),
                                      z["episode_returns"].sum())):
                fail(f"phase s: record_demos -policy {policy} wrote "
                     f"{layout}")
            # a row a policy draw: the rows before the first action apart
            rows = None if first is None else first
            same = all(np.array_equal(z[k][:rows], zh[k][:rows])
                       for k in ("obs", "actions", "rewards",
                                 "episode_starts"))
            if not same or (first is None and not all(
                    np.array_equal(z[k], zh[k]) for k in z)):
                fail(f"phase s: record_demos -policy {policy}'s npz on the "
                     "card differs from the CPU's before any action apart")
            print(f"[s] {tag}: the npz ({n} rows) on the card equal to the "
                  "CPU's " + ("in every array" if first is None else
                              f"in its first {first} rows (an action apart "
                              f"at a Gumbel gap of {gap:.3g})"))
        cut = " ".join(f"{f} {c}" for f, (c, _) in S_DAGGER.items())
        tag = ("dagger NovelGridworld-Pogostick-v0 " + ", ".join(
            f"{f} {c} (ngx's default {d})" for f, (c, d) in
            S_DAGGER.items()) + ", ngx's keys")
        got = run(tag, dagger.main, lambda d: [
            "-env", "NovelGridworld-Pogostick-v0", "-hidden", "64,64",
            "-eval_episodes", str(S_EVAL_EPISODES), "-ckpt",
            os.path.join(tmp, f"dagger-{d.type}")] + cut.split())
        (out_c, tr_c, res, _), (out_h, tr_h, res_h, _) = got
        first, gap, _ = _s_first_mismatch("[s] dagger", tr_c, tr_h)
        rows_c, rows_h = _s_round_rows(out_c), _s_round_rows(out_h)
        # the rounds whose data no mismatched collection fed: the dataset
        # equal, bc_acc and solve within 1% (of frames, of episodes: the
        # BC parameters round otherwise on the card, the eval's actions
        # are categorical draws), return within 1% of 200
        fed = len(rows_h) if first is None else len(_s_round_rows(
            "\n".join(out_h.splitlines()[:tr_h[first][3]])))
        if len(rows_c) != len(rows_h) or not rows_h:
            fail(f"[s] dagger printed {len(rows_c)} rounds on the card, "
                 f"{len(rows_h)} on the CPU")
        for rc, rh in list(zip(rows_c, rows_h))[:fed]:
            if rc[:2] != rh[:2] or abs(rc[2] - rh[2]) > 1.0 or \
                    abs(rc[3] - rh[3]) > 1.0 or abs(rc[4] - rh[4]) > 2.0:
                fail(f"[s] dagger's round {int(rh[0])} on the card {rc} "
                     f"against the CPU's {rh}")
        print(f"[s] dagger's round lines: card {rows_c}, CPU {rows_h}; "
              + ("equal" if rows_c == rows_h else "inside the rule")
              + ("" if first is None else
                 f"; a collection action apart at policy draw {first} "
                 f"(Gumbel gap {gap:.3g})"))
        policy = enjoy.load_policy(os.path.join(tmp, f"dagger-{dev.type}",
                                                "best.pt"),
                                   nt.lidar_in_front(nt.make_spec(
                                       "NovelGridworld-Pogostick-v0")), dev)
        if res["best"] is None or policy.device != dev:
            fail("phase s: dagger saved no best.pt that enjoy can load")
        print(f"[s] {smi}: dagger's best solve rate {res['best'][0]} "
              f"(return {res['best'][1]}; the CPU's {res_h['best']}); "
              f"seconds by part on the card "
              f"{ {k: round(v, 3) for k, v in res['seconds'].items()} }, "
              f"on the CPU "
              f"{ {k: round(v, 3) for k, v in res_h['seconds'].items()} }; "
              "best.pt loads through enjoy.load_policy")
    print(f"[s] {smi}: phase s took {time.perf_counter() - t_s:.3f} s "
          "(phase timer, host clock)")


# phase t: the last modules of ngx — NGX_DEBUG, the trajectory recorder, the
# Monitor CSV, and the socket, keyboard and eval_agents drivers
T_ENVS = ("NovelGridworld-v0", POGO)
T_EVAL_EPISODES, T_SOCKET_STEPS, T_DEBUG_STEPS = 128, 20, 100
T_MONITOR_CAP = 400
T_KEYS = ("w", "a", "e", "1", "Forward", "xyz", "d", "w", "e", "b", "2",
          "x", "w", "w", "e", "e", "quit")


def _t_ngx_report(root):
    """ngx's published evaluation: ``results/eval.json``'s rows of the
    ``T_ENVS`` (128 episodes, seed 0, cap 100) and ``docs/EVAL.md``'s chain
    rows, ``{name: (solve % text, mean return text)}`` at the document's
    precision."""
    with open(os.path.join(root, "results", "eval.json")) as f:
        envs = json.load(f)["envs"]
    rows = {(e, row): envs[e][row] for e in T_ENVS
            for row in ("trained", "random", "solver") if row in envs[e]}
    with open(os.path.join(root, "docs", "EVAL.md")) as f:
        found = re.findall(r"\*\*solve (\d+)%, mean return ([\d.]+)\*\*",
                           f.read())
    if len(found) != 2:
        fail(f"docs/EVAL.md: the chain rows read {found}")
    return rows, dict(zip(("chain", "chain_solver"), found))


def _same_tensors(a, b):
    """``a`` (on any device) equal to ``b``: tensors by dtype, shape and
    value; dicts and dataclasses of them field by field."""
    import torch

    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(b, dict):
        return list(a) == list(b) and all(_same_tensors(a[k], b[k])
                                          for k in b)
    return type(a) is type(b) and _same_tensors(vars(a), vars(b))


def _t_debug(dev, smi):
    """NGX_DEBUG=1 on ``dev``: a clean run of a fresh step, counter reset
    and VecEnv; three corrupted states; the kernel entries refused; one
    'xla' train step.  Returns the plain and debug step's ms."""
    import torch

    import ngx_torch as nt
    from ngx_torch.rl.train import PPOConfig, make_train
    from ngx_torch.vector import make_vec, throughput_fn

    spec = nt.make_spec(POGO)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    def steps_ms(step, state):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(T_DEBUG_STEPS):
            state = step(state, zeros)[0]
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3 / T_DEBUG_STEPS

    plain = nt.make_step(spec)
    start = nt.counter_reset(spec, SEED, 0, B, device=dev)
    plain_ms = steps_ms(plain, start)
    old = os.environ.get("NGX_DEBUG")
    os.environ["NGX_DEBUG"] = "1"
    try:
        step = nt.make_step(spec)
        debug_ms = steps_ms(step, nt.counter_reset(spec, SEED, 0, B,
                                                   device=dev))
        vec = make_vec(spec, episode_cap=CAP // 4)
        state, _ = vec.reset(SEED, B, device=dev)
        state, traj = vec.rollout(state, SEED, None, T_DEBUG_STEPS)
        n_done = int(traj.dones.sum())
        print(f"[t] NGX_DEBUG=1: a clean {T_DEBUG_STEPS}-step random run of "
              f"make_vec({POGO}, cap {CAP // 4}) at B {B} on {dev}, "
              f"{n_done} episode ends and resets, passed")
        one = nt.counter_reset(spec, SEED, 0, 4, device=dev)
        inv, ring = one.inventory.clone(), one.map.clone()
        inv[2, 1] = -3
        ring[:, 0] = 0
        env2 = torch.tensor([2], device=dev)
        text = ("NGX_DEBUG: invariant violated after step: {} (env index {} "
                "of the callback batch; 1 total violations)")
        for what, bad, want in (
                ("negative inventory", one.replace(inventory=inv).take(env2),
                 text.format("inventory >= 0", 0)),
                ("broken wall ring", one.replace(map=ring).take(env2),
                 text.format("wall ring intact (ring cells != air)", 0)),
                ("batched negative inventory", one.replace(inventory=inv),
                 text.format("inventory >= 0", 2))):
            try:
                step(bad, zeros[:bad.batch])
            except AssertionError as e:
                if str(e) != want:
                    fail(f"phase t: NGX_DEBUG on a {what}: {e}")
                print(f"[t] NGX_DEBUG=1 on a {what} on {dev}: raised {e}")
            else:
                fail(f"phase t: NGX_DEBUG did not catch a {what}")
        # a corrupt facing: ngx's text after a Forward, and the context
        # still usable (an out-of-range index would be a device-side assert)
        one5 = one.take(env2).replace(
            facing=torch.full((1,), 5, dtype=torch.int32, device=dev))
        fwd = torch.full((1,), spec.actions_id["Forward"], dtype=torch.int32,
                         device=dev)
        try:
            step(one5, fwd)
        except AssertionError as e:
            if str(e) != text.format("facing in {0,1,2,3}", 0):
                fail(f"phase t: NGX_DEBUG on facing 5: {e}")
            print(f"[t] NGX_DEBUG=1 on facing 5 after a Forward on {dev}: "
                  f"raised {e}")
        else:
            fail("phase t: NGX_DEBUG did not catch facing 5")
        after = step(one.take(env2), fwd)[0]
        _sync(dev)
        print(f"[t] after it, a plain step on {dev} runs: agent "
              f"{after.agent.tolist()}, facing {after.facing.tolist()}")
        cfg = PPOConfig(num_envs=B, rollout_steps=T, hidden=HIDDEN)
        for name, build in (
                ("throughput_fn", lambda: throughput_fn(spec, B, T,
                                                        device=dev)),
                ("make_train", lambda: make_train(cfg, device=dev))):
            try:
                build()
            except RuntimeError as e:
                print(f"[t] NGX_DEBUG=1: {name} refused: {e}")
            else:
                fail(f"phase t: {name} built a kernel path under NGX_DEBUG")
        init, train_step = make_train(cfg, rollout_backend="xla", device=dev)
        t0 = time.perf_counter()
        _, m = train_step(init(SEED), SEED + 1)
        _sync(dev)
        if not all(math.isfinite(float(m[k]))
                   for k in ("pg_loss", "v_loss", "entropy")):
            fail(f"phase t: the xla train step under NGX_DEBUG: {m}")
        print(f"[t] {smi}: NGX_DEBUG=1: one make_train(rollout_backend="
              f"'xla') step at B {B}, T {T}: {time.perf_counter() - t0:.3f} "
              "s, finite losses")
    finally:
        if old is None:
            del os.environ["NGX_DEBUG"]
        else:
            os.environ["NGX_DEBUG"] = old
    # with the flag off, a step from facing 5 (every action) equals the CPU
    n_a = spec.n_actions
    acts = torch.arange(n_a, dtype=torch.int32, device=dev)
    bad = nt.counter_reset(spec, SEED, 0, n_a, device=dev)
    bad = bad.replace(facing=torch.full_like(bad.facing, 5))
    card, cpu = plain(bad, acts), plain(bad.to("cpu"), acts.cpu())
    same = all(_same_tensors(x, y) for x, y in zip(card, cpu))
    if not same:
        fail("phase t: the step from facing 5 on the card differs from the "
             "CPU's")
    print(f"[t] the step from facing 5 under each of the {n_a} actions on "
          f"{dev}: state, obs, reward, done and info equal the CPU's; "
          f"facing after {card[0].facing.tolist()}")
    print(f"[t] {smi}: a {POGO} step at B {B} ({T_DEBUG_STEPS} steps, host "
          f"clock): plain {plain_ms:.4f} ms (before the facing repair: "
          "5.1003 / 5.8900 ms, PERF.md section 5), "
          f"under NGX_DEBUG=1 {debug_ms:.4f} ms "
          f"({debug_ms / plain_ms:.3f}x)")
    return plain_ms, debug_ms


def _phase_t(dev, smi):
    """Phase t (module docstring) on ``dev``: every check fatal.  Returns
    the ``native_reset`` launches of ``evaluate_chain`` at eval_agents'
    shape and the largest error of its stage-0 draw against the CPU's."""
    import contextlib
    import io
    import pickle

    import numpy as np
    import torch

    import ngx_torch as nt
    import ngx_torch.compat as TC
    from ngx_torch.cli import eval_agents
    from ngx_torch.cli.socket_agent import serve_and_talk
    from ngx_torch.cli.socket_env import serve
    from ngx_torch.ops import native_reset as NR
    from ngx_torch.ops import threefry as TF
    from ngx_torch.rl.curriculum import evaluate_chain, make_chain_reset
    from ngx_torch.rl.evaluate import evaluate_expert
    from ngx_torch.transforms import TrajectoryRecorder
    from ngx_torch.utils import (Monitor, load_results, restore_checkpoint,
                                 ts2xy)

    t_t = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    quiet = contextlib.redirect_stdout
    secs = {}

    # ---- 1. NGX_DEBUG ------------------------------------------------------
    t0 = time.perf_counter()
    _t_debug(dev, smi)
    secs["NGX_DEBUG"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 2. TrajectoryRecorder: one episode, card and CPU ------------
        t0 = time.perf_counter()
        pickles = {}
        for i, d in enumerate((dev, "cpu")):
            rec = TrajectoryRecorder(nt.make_spec(POGO),
                                     os.path.join(tmp, f"traj{i}"))
            _s_play(lambda d: TC.make(POGO, device=d), d, 3, episodes=1,
                    on_state=lambda e: rec.record(e.get_state()))
            with quiet(io.StringIO()):
                path = rec.save()
            with open(path, "rb") as f:
                pickles[i] = pickle.load(f)
        got, want = pickles[0], pickles[1]
        if not (len(got) > 1 and _s_same(got, want)):
            fail("phase t: TrajectoryRecorder's pickles differ between the "
                 "card and the CPU")
        secs["TrajectoryRecorder"] = time.perf_counter() - t0
        print(f"[t] {smi}: TrajectoryRecorder: one random {POGO} episode, "
              f"{len(got)} states recorded on {dev} and on the CPU: the "
              f"pickles load to equal lists "
              f"({secs['TrajectoryRecorder']:.3f} s)")

        # ---- 3. Monitor: 3 episodes, card and CPU --------------------------
        t0 = time.perf_counter()
        rows = {}
        for i, d in enumerate((dev, "cpu")):
            log = os.path.join(tmp, f"monitor{i}")
            monitors = []

            def make_monitor(d):
                monitors.append(Monitor(TC.make("NovelGridworld-v0",
                                                device=d), log))
                return monitors[-1]

            trace, _ = _s_play(make_monitor, d, 4, episodes=3,
                               cap=T_MONITOR_CAP)
            monitors[0].close()
            ends = sum(bool(out[2]) for out in trace if len(out) == 4)
            rows[i] = load_results(log)
        got, want = rows[0], rows[1]
        x, y = ts2xy(got)
        if (not 1 <= len(got) == ends or [(r["r"], r["l"]) for r in got]
                != [(r["r"], r["l"]) for r in want]
                or list(x) != list(np.cumsum([r["l"] for r in want]))):
            fail(f"phase t: Monitor rows {got} against the CPU's {want}")
        secs["Monitor"] = time.perf_counter() - t0
        print(f"[t] {smi}: Monitor: 3 random NovelGridworld-v0 episodes on "
              f"{dev} (cap {T_MONITOR_CAP}), {ends} ended: rows (r, l) "
              f"{[(r['r'], r['l']) for r in got]} equal the CPU's; ts2xy x "
              f"{list(x)} ({secs['Monitor']:.3f} s)")

    # ---- 4. socket_env, by socket_agent's protocol -------------------------
    spec6 = nt.make_spec("NovelGridworld-v6")
    rng = np.random.RandomState(SEED % 1000)
    actions = [spec6.actions[int(rng.randint(spec6.n_actions))]
               for _ in range(T_SOCKET_STEPS)]

    def talk(d):
        np.random.seed(SEED % 1000)
        return serve_and_talk(serve, TC.make("NovelGridworld-v6", device=d),
                              actions)

    try:
        card, card_s = talk(dev)
        cpu, cpu_s = talk("cpu")
    except (OSError, RuntimeError) as e:
        fail(f"phase t: socket_env: {e!r}")
    if card != cpu or len(card) != T_SOCKET_STEPS:
        fail("phase t: the card's socket replies differ from the CPU's")
    for reply in card:
        if set(json.loads(reply)) != {"observation", "reward", "done"}:
            fail(f"phase t: socket reply {reply[:200]!r}")
    secs["socket"] = card_s + cpu_s
    print(f"[t] {smi}: socket_env on {dev}: {T_SOCKET_STEPS} actions, "
          f"every reply equal to the CPU server's "
          f"({sum(map(len, card))} bytes); round trip "
          f"{card_s / T_SOCKET_STEPS * 1e3:.4f} ms an action on the card, "
          f"{cpu_s / T_SOCKET_STEPS * 1e3:.4f} ms on the CPU (host clock)")

    # ---- 5. keyboard_play in subprocesses -----------------------------------
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ngx_torch.cli.keyboard_play", "-seed", "3",
         "-device", d], cwd=root, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for d in (str(dev), "cpu")]
    outs = []
    for d, proc in zip((str(dev), "cpu"), procs):
        try:
            out, err = proc.communicate("\n".join(T_KEYS) + "\n", timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail("phase t: keyboard_play did not finish")
        if proc.returncode != 0:
            fail(f"phase t: keyboard_play -device {d}: rc "
                 f"{proc.returncode}\n{err[-3000:]}")
        outs.append(out.splitlines())
    got, want = outs
    n_steps = sum(line.startswith("action> action:") for line in got)
    if got != want or n_steps < 10:
        fail("phase t: keyboard_play's transcript on the card differs from "
             "the CPU's")
    secs["keyboard_play"] = time.perf_counter() - t0
    print(f"[t] keyboard_play -device {dev}: {len(got)} lines, {n_steps} "
          "steps, equal to -device cpu's line for line "
          f"({secs['keyboard_play']:.3f} s, two subprocesses)")

    # ---- 6. eval_agents on ngx's keys: 2 envs and the chain ---------------
    want_rows, want_chain = _t_ngx_report(root)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with quiet(io.StringIO()):
            report = eval_agents.main([
                "-envs", ",".join(T_ENVS), "-episodes", str(T_EVAL_EPISODES),
                "-seed", "0", "-agents",
                os.path.join(root, "trained_agents_torch"), "-ref_agents", "",
                "-out", os.path.join(tmp, "eval.json"),
                "-md", os.path.join(tmp, "EVAL.md"), "-device", str(dev)])
        _sync(dev)
        eval_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "EVAL.md")) as f:
            md = f.read()
    for (env_id, row), want in want_rows.items():
        got = report["envs"][env_id][row]
        print(f"[t] eval_agents {env_id} {row}: {got} (ngx's "
              f"results/eval.json: {want})")
        if got != want:
            fail(f"phase t: eval_agents {env_id} {row} {got} is not ngx's "
                 f"{want}")
    for name, (solve, ret) in want_chain.items():
        got = report[name]
        digits = len(ret.split(".")[1]) if "." in ret else 0
        print(f"[t] eval_agents {name}: {got} (ngx's docs/EVAL.md: solve "
              f"{solve}%, mean return {ret})")
        if (f"{got['solve_rate'] * 100:.0f}" != solve
                or f"{got['mean_return']:.{digits}f}" != ret):
            fail(f"phase t: eval_agents {name} {got} is not ngx's solve "
                 f"{solve}%, mean return {ret}")
    t0 = time.perf_counter()
    for env_id in T_ENVS:
        cpu = evaluate_expert(env_id, episodes=T_EVAL_EPISODES, cap=S_CAP,
                              seed=0, device="cpu")
        if report["envs"][env_id]["expert"] != cpu:
            fail(f"phase t: eval_agents' expert row on {env_id} "
                 f"{report['envs'][env_id]['expert']} against the CPU's "
                 f"{cpu}")
    cpu_expert_s = time.perf_counter() - t0
    for claim in ("v5e", "TPU", "M env steps", "96%", "90%", "counter RNG"):
        if claim in md:
            fail(f"phase t: eval_agents' markdown states {claim!r}")
    secs["eval_agents"] = eval_s
    print(f"[t] {smi}: eval_agents -envs {','.join(T_ENVS)} -episodes "
          f"{T_EVAL_EPISODES} on {dev}, ngx's keys: {eval_s:.3f} s; seconds "
          f"by part {json.dumps(report['seconds'])}; every policy, random "
          f"and chain row equal to ngx's report; expert rows equal the "
          f"CPU's ({cpu_expert_s:.3f} s on the CPU)")

    # ---- 7. the chain's stage-0 draw, re-derived from the key -------------
    # evaluate_chain(seed=0) at eval_agents' shape: k0, _ = split(key(0)),
    # and the chain's stage 0 is ngx's native reset over split(k00, E) with
    # k00, _ = split(k0): one native_reset launch on the card, counted (the
    # budget steps hold a done env, they never reset one)
    params = [restore_checkpoint(os.path.join(
        root, "trained_agents_torch", "chain", e, "best.pt"))["params"]
        for e in CHAIN]
    before = NR.native_reset.launches
    t0 = time.perf_counter()
    row = evaluate_chain(CHAIN, params[:-1], params[-1],
                         episodes=T_EVAL_EPISODES, cap=S_CAP, seed=0,
                         device=dev)
    _sync(dev)
    secs["evaluate_chain"] = time.perf_counter() - t0
    draws = NR.native_reset.launches - before
    if dev.type == "cuda" and draws != 1:
        fail(f"phase t: evaluate_chain launched {draws} native resets "
             "(expected its stage-0 draw alone)")
    k0, _ = TF.split(TF.key(0))
    keys0 = TF.split(TF.split(k0)[0], T_EVAL_EPISODES)
    v2 = nt.lidar_in_front(nt.make_spec(CHAIN[0]))
    draw, _ = nt.make_reset(v2, dev)(keys0)
    draw_p, _ = nt.make_reset(v2, "cpu")(keys0)
    # the chain of the first env alone plays no stage: its state is the
    # stage-0 draw the chain made from k0
    made = make_chain_reset(CHAIN[:1], [], T_EVAL_EPISODES, S_CAP,
                            dev)[0](k0)[0]
    differ = torch.zeros(T_EVAL_EPISODES, dtype=torch.bool)
    draw_err = 0.0
    for name, x in draw.__dict__.items():
        y = getattr(draw_p, name)
        differ |= (x.cpu() != y).reshape(T_EVAL_EPISODES, -1).any(1)
        draw_err = max(draw_err, float((x.cpu().long() - y.long()).abs()
                                       .max()))
    print(f"[t] {smi}: evaluate_chain(seed 0) {row} "
          f"({secs['evaluate_chain']:.3f} s, {draws} native_reset "
          f"launches); its stage-0 draw ({T_EVAL_EPISODES} native resets of "
          f"{CHAIN[0]} re-derived from key(0)) on {dev} vs the CPU's plain "
          f"draw: {int(differ.sum())} rows differ, max |err| {draw_err}")
    if bool(differ.any()):
        fail("phase t: the chain's stage-0 draw differs from the CPU's")
    if not _same_tensors(made, draw):
        fail("phase t: the chain's stage-0 state is not the draw "
             "re-derived from its key")
    print(f"[t] {smi}: phase t took {time.perf_counter() - t_t:.3f} s "
          f"(phase timer, host clock); by part "
          f"{ {k: round(v, 3) for k, v in secs.items()} }")
    return draws, draw_err


# phase u: the gym_novel_gridworlds drop-in surface (ngx_torch.dropin) and
# the plain path, and the kernels, on more than 32 item ids and on NOOP
U_CAP, U_NOVELTY_STEPS, U_WIDE_ADDS, U_VEC_B, U_VEC_T = 100, 20, 30, 256, 100
U_NOVELTY_CLASSES = (
    ("AxeEasy", ("wooden",), POGO), ("AxeMedium", ("iron",), POGO),
    ("AxeHard", ("iron", "true"), POGO), ("AxetoBreakEasy", ("wooden",), POGO),
    ("AxetoBreakMedium", ("iron",), POGO),
    ("AxetoBreakHard", ("iron",), POGO), ("Fence", ("easy", "oak"), POGO),
    ("FenceRestriction", ("medium", "oak"), POGO),
    ("AddItem", ("hard", "fence"), POGO), ("Crate", ("easy",), POGO),
    ("ReplaceItem", ("medium", "tree_log", "stone"), POGO),
    ("FireWall", ("easy",), POGO), ("AddChopAction", (), POGO),
    ("AddJumpAction", (), POGO), ("BreakIncrease", ("tree_log",), POGO),
    ("ExtractIncDec", ("increase",), "NovelGridworld-Bow-v1"),
)


def _u_wide(nt):
    """Pogostick-v1 with 30 stacked additems: 39 item ids."""
    spec = nt.make_spec(POGO)
    for k in range(U_WIDE_ADDS):
        spec = nt.inject_novelty(spec, "additem", "easy", f"thing{k}")
    return spec


def _u_surface(device):
    """Every part of the drop-in surface that phase u holds between the
    card and the CPU, through ``gym_novel_gridworlds`` after ``install(
    device)``: ``{part: trace}`` and the facade steps taken."""
    import numpy as np

    import gym
    import gym_novel_gridworlds as gnw
    from gym_novel_gridworlds import envs, novelty_wrappers as nw
    from gym_novel_gridworlds.observation_wrappers import LidarInFront
    from gym_novel_gridworlds.wrappers import LimitActions

    out, steps = {}, 0

    def play(part, make_env, seed, cap):
        nonlocal steps
        trace, n = _s_play(lambda _: make_env(), device, seed, episodes=1,
                           cap=cap)
        out[part] = trace
        steps += n

    for i, env_id in enumerate(gnw.ENV_IDS):
        cls = getattr(envs, envs.CLASS_NAMES[env_id])
        play(f"class {cls.__name__}", cls, 10 + i, U_CAP)
        play(f"gym.make {env_id}", lambda e=env_id: gym.make(e), 30 + i,
             U_CAP)

    def stack():
        env = gnw.make("NovelGridworld-Bow-v0")
        env = LimitActions(env, {"Forward", "Left", "Right", "Break",
                                 "Extract_string", "Craft_bow"})
        return nw.inject_novelty(LidarInFront(env, num_beams=8),
                                 "firewall", "easy")

    play("make -> LimitActions -> LidarInFront -> firewall easy", stack, 3,
         U_CAP)
    for i, (name, args, env_id) in enumerate(U_NOVELTY_CLASSES):
        def wrapped(name=name, args=args, env_id=env_id):
            base = gnw.make(env_id)
            base.reset()
            return getattr(nw, name)(base, *args)
        play(f"{name}{args}", wrapped, 50 + i, U_NOVELTY_STEPS)
    for limited in (False, True):
        np.random.seed(9)
        env = gnw.make(POGO)
        if limited:
            env = LimitActions(env, {"Forward", "Left", "Right", "Break"})
        env.reset()
        env = nw.remap_action_difficulty(env, "hard")
        out[f"remap_action_difficulty, limited {limited}"] = [
            dict(env.limited_actions_id or env.actions_id), env.step(0),
            env.step(1)]
        steps += 2
    np.random.seed(11)
    e2 = envs.NovelGridworldV2Env()
    trace = [e2.reset()] + [e2.step(a) for a in (0, 1, 0)]
    e3 = envs.NovelGridworldV3Env(env=e2)
    trace += [e3.reset()] + [e3.step(a) for a in range(e3.action_space.n)]
    out["v2 -> v3 restore chaining"] = trace + [e3.map,
                                                e3.inventory_items_quantity]
    steps += 3 + e3.action_space.n
    return out, steps


def _phase_u(dev, smi, H):
    """Phase u (module docstring) on ``dev``, every check fatal, with the
    main's helpers in ``H``."""
    import io

    import numpy as np
    import torch

    import ngx_torch as nt
    import ngx_torch.compat as TC
    import ngx_torch.dropin as dropin
    from ngx_torch.rl.train import PPOConfig, make_train
    from ngx_torch.vector import make_vec, throughput_fn

    t_u = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    # ---- 1. the import, with jax blocked -----------------------------------
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'flax', 'optax'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import ngx_torch.dropin\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('ngx', 'jax', 'flax', 'optax',\n"
            "              'gym_novel_gridworlds'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        fail(f"phase u: import ngx_torch.dropin with jax blocked:\n"
             f"{proc.stderr[-3000:]}")
    print("[u] import ngx_torch.dropin in a subprocess with jax blocked: "
          "no ngx, jax or gym_novel_gridworlds module loaded")

    # ---- 2. the surface on the card against the CPU ----------------------
    shim = os.path.join(root, "tests", "_gym_shim")
    sys.path.insert(0, shim)
    traces, secs = [], []
    try:
        for d in (dev, torch.device("cpu")):
            dropin.install(device=d)
            if not dropin.GYM_REGISTERED:
                fail("phase u: install() registered nothing with the gym "
                     "stand-in")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trace, n_steps = _u_surface(d)
            traces.append(trace)
            secs.append(time.perf_counter() - t0)
    finally:
        dropin.uninstall()
        sys.path.remove(shim)
        for m in [m for m in sys.modules if m == "gym"
                  or m.startswith("gym.")]:
            del sys.modules[m]
    card, cpu = traces
    differ = [part for part in cpu if not _s_same(card[part], cpu[part])]
    if list(card) != list(cpu) or differ:
        fail(f"phase u: the drop-in surface on {dev} differs from the CPU "
             f"in {differ}")
    print(f"[u] the drop-in surface through gym_novel_gridworlds after "
          f"install(device=...): {len(cpu)} parts (the 11 classes and "
          f"gym.make of the 11 ids, one random episode each at cap {U_CAP}; "
          f"the reference stack; the {len(U_NOVELTY_CLASSES)} novelty "
          f"classes, {U_NOVELTY_STEPS} random actions each; "
          f"remap_action_difficulty twice; v2 -> v3 restore chaining), "
          f"{n_steps} facade steps: every obs (value and dtype), reward, "
          f"done and info on {dev} equal the CPU's")
    print(f"[u] {smi}: a facade step under the alias (host clock, "
          f"{n_steps} steps): {secs[0] / n_steps * 1e3:.4f} ms on "
          f"{dev}, {secs[1] / n_steps * 1e3:.4f} ms on the CPU")

    # ---- 3. the plain path, and the kernels, past 32 item ids and on NOOP --
    wide = _u_wide(nt)
    op = np.asarray(nt.make_spec(POGO).action_op).copy()
    op[nt.make_spec(POGO).actions_id["Left"]] = nt.core.spec.OP_NOOP
    noop = nt.make_spec(POGO).replace(action_op=op)
    t0 = time.perf_counter()
    traces = []
    for d in (dev, "cpu"):
        env = TC.make(POGO, device=d)
        for k in range(U_WIDE_ADDS):
            env = TC.inject_novelty(env, "additem", "easy", f"thing{k}")
        traces.append(_s_play(lambda _: env, d, 21, episodes=1,
                              cap=U_VEC_T)[0])
    if not _s_same(*traces):
        fail(f"phase u: the 39-item facade on {dev} differs from the CPU")
    for name, spec in (("39 item ids", wide), ("NOOP", noop)):
        vec = make_vec(nt.lidar_in_front(spec), episode_cap=25)
        runs = []
        for d in (dev, torch.device("cpu")):
            state, _ = vec.reset(SEED, U_VEC_B, device=d)
            runs.append(vec.rollout(state, SEED, None, U_VEC_T))
        if not all(_same_tensors(x, y) for x, y in zip(
                [runs[0][0], *runs[0][1]], [runs[1][0], *runs[1][1]])):
            fail(f"phase u: make_vec on the {name} spec on {dev} differs "
                 "from the CPU")
        print(f"[u] {name}: make_vec at B {U_VEC_B}, {U_VEC_T} random "
              f"steps (cap 25, {int(runs[0][1].dones.sum())} episode ends) "
              f"on {dev}: state and trajectory equal the CPU's")
    print(f"[u] the 39-item facade ({wide.n_items} item ids): a random "
          f"episode of {len(traces[1]) - 1} steps on {dev} equals the "
          f"CPU's ({time.perf_counter() - t0:.3f} s with make_vec)")
    cfg = PPOConfig(num_envs=B, rollout_steps=T, hidden=HIDDEN)
    # the kernels take the 39-item spec: 'auto' trains on them, the draw and
    # the launch held against their twins on the same inputs
    with _v_held(H, "[u] make_train on 39 ids") as held:
        init, train_step = make_train(cfg, spec_override=wide, device=dev)
        _, m = train_step(init(SEED), SEED + 1)
    state, mean = throughput_fn(wide, B, T, device=dev)(SEED)
    _v_hold_throughput(H, "[u] throughput_fn on 39 ids", wide, T, state,
                       mean)
    if (train_step.rollout_backend, train_step.reset_source) != \
            ("pallas", "pool") or len(held) != 2 or not all(
                math.isfinite(float(x)) for x in
                (m["pg_loss"], m["v_loss"], m["entropy"], mean)):
        fail(f"phase u: the 39-item spec on the kernels: "
             f"{train_step.rollout_backend}, {train_step.reset_source}, "
             f"{len(held)} held, {m}, {float(mean)}")
    print(f"[u] make_train(..., 'auto') on the 39-item spec took the acting "
          f"kernel with pool resets, one step, finite losses, its draw and "
          f"launch equal to their twins; throughput_fn at B {B}, T {T}: "
          f"mean reward {float(mean)}, equal to its twin's")
    init, train_step = make_train(cfg, spec_override=wide,
                                  rollout_backend="xla", device=dev)
    t0 = time.perf_counter()
    _, m = train_step(init(SEED), SEED + 1)
    _sync(dev)
    if not all(math.isfinite(float(m[k]))
               for k in ("pg_loss", "v_loss", "entropy")):
        fail(f"phase u: the 39-item xla train step: {m}")
    print(f"[u] {smi}: one make_train(..., rollout_backend='xla') step on "
          f"the 39-item spec at B {B}, T {T}: "
          f"{time.perf_counter() - t0:.3f} s, finite losses "
          f"{ {k: round(float(m[k]), 6) for k in ('pg_loss', 'v_loss')} }")
    print(f"[u] {smi}: phase u took {time.perf_counter() - t_u:.3f} s "
          "(phase timer, host clock)")


# phase v: the kernels over ngx's whole spec domain
V_WIDE_ADDS = (60, 130)        # additems: 70 and 140 item ids with newwall
V_EDGE_ADDS = (55, 56)         # additems: 64 item ids (int8), 65 (int16)
V_CLOCKS = (1, 17, 33, 49)     # native resets at steps 0, 16, 32 and 48


def _v_specs(nt):
    """Phase v's specs under LidarInFront: phase u's 39-item spec (int8
    cells; the main path's); Pogostick-v1 with 60 or 130 stacked additems
    and the wall replaced by a new item (70 and 140 item ids: the map cell
    is int16, ids past 63 and past 127 lie on every map), fence medium on
    top of the 70 (the native reset's fence edit over cells holding such
    ids), the 140 with its reset edits taken out (a wide spec that trains
    with native resets), Pogostick-v1 with Left as NOOP, and 55 and 56
    stacked additems (64 and 65 item ids: the last int8 and the first int16
    spec, one reset edit apart)."""
    import numpy as np

    def stack(n_add):
        sp = nt.make_spec(POGO)
        for k in range(n_add):
            sp = nt.inject_novelty(sp, "additem", "easy", f"thing{k}")
        return sp

    def wide(n_add, fence=False):
        sp = nt.inject_novelty(stack(n_add), "replaceitem", "hard", "wall",
                               "newwall")
        if fence:
            sp = nt.inject_novelty(sp, "fence", "medium", "oak")
        return sp

    base = nt.make_spec(POGO)
    op = np.asarray(base.action_op).copy()
    op[base.actions_id["Left"]] = nt.core.spec.OP_NOOP
    w70, w140 = (wide(n) for n in V_WIDE_ADDS)
    specs = {"39 ids": stack(U_WIDE_ADDS), "70 ids": w70,
             "70 ids + fence": wide(V_WIDE_ADDS[0], True), "140 ids": w140,
             "140 ids, no reset edits": w140.replace(reset_edits=()),
             "NOOP": base.replace(action_op=op),
             "64 ids": stack(V_EDGE_ADDS[0]), "65 ids": stack(V_EDGE_ADDS[1])}
    return {k: nt.lidar_in_front(v) for k, v in specs.items()}


def _v_copy(x):
    """A copy of a call's tensors and states, which its caller may change
    later (the optimizer updates the weights in place)."""
    import torch

    from ngx_torch.core.state import EnvState

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, EnvState):
        return x.replace(**{k: v.clone() for k, v in x.__dict__.items()})
    if isinstance(x, (list, tuple)):
        return type(x)(_v_copy(y) for y in x)
    if isinstance(x, dict):
        return {k: _v_copy(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def _v_held(H, tag, seeds=None, module=None):
    """Keep every ``train_rollout`` and ``pool_reset`` that ``make_train``
    calls inside the block (``ngx_torch.rl.train``'s names, or those of
    them ``module`` has: ``ngx_torch.rl.curriculum``'s ``train_rollout``
    for ``make_train_chain``, which draws no pool), its inputs and
    outputs copied, and after the block hold each against its plain version
    on the same inputs: the draw bit for bit against ``reset_rows``, the
    launch against ``train_rollout_plain`` by phase 3's rule (its seed's
    Gumbel scores at a mismatch; an episode end not required).  The twins
    launch no kernel, so the counts stay the main path's.  Yields the list
    of ``(what, max |err|)`` held, filled at the exit; ``seeds``, a list,
    gets each call's ``(what, seed)`` in call order."""
    import torch

    import ngx_torch.rl.train
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.ops import train_rollout as TR

    TRN = module or ngx_torch.rl.train
    real = {name: getattr(TRN, name) for name in ("train_rollout",
                                                  "pool_reset")
            if hasattr(TRN, name)}
    kept, held = [], []

    def keep(name):
        def run(*a, **kw):
            out = real[name](*a, **kw)
            kept.append((name, _v_copy(a), _v_copy(kw), _v_copy(out)))
            return out
        return run

    for name in real:
        setattr(TRN, name, keep(name))
    try:
        yield held
    finally:
        for name, fn in real.items():
            setattr(TRN, name, fn)
    for name, a, kw, out in kept:
        if seeds is not None:
            seeds.append((name, a[2] if name == "pool_reset" else a[3]))
        if name == "pool_reset":
            sp, n, seed = a[:3]
            want = reset_rows(ResetTables(sp), seed, 0,
                              torch.arange(n, device=out.device))
            bad = int((~H.compare_states(out, want, n)).sum())
            print(f"{tag}: its pool draw ({n} resets, seed {seed}) against "
                  f"reset_rows on the same seed: {bad} rows differ")
            if bad:
                fail(f"{tag}: a pool draw differs from reset_rows")
            held.append((name, 0.0))
            continue
        sp, st, lay, seed, steps = a
        want = TR.train_rollout_plain(sp, st, lay, seed, steps, **kw)
        mode = "native resets" if kw.get("pool") is None else \
            "pool restores"
        held.append((name, H.check_agreement(
            f"{tag}: its launch {len(held)}", sp, out, want, lay, kw["block"],
            kw["cap"], mode, "plain twin on the same inputs", seed=seed,
            need_done=False)))


def _v_hold_throughput(H, tag, sp, steps, state, mean):
    """``throughput_fn(sp, B, steps)(SEED)``'s final state and mean reward
    against ``rollout_plain`` on the same inputs (its RNG blocks of 512),
    bit for bit; returns the twin's ms."""
    from ngx_torch.ops import rollout as R

    out_p, p_ms = H.sync_ms(lambda: R.rollout_plain(
        sp, B, steps, SEED, 512, "prng", device=state.device))
    n_bad = int((~H.compare_states(state, out_p[0])).sum())
    mean_p = out_p[1].sum() / (B * steps)
    print(f"{tag} at B={B} T={steps}: {n_bad} envs differ from the twin on "
          f"the same inputs, mean reward {float(mean)} against "
          f"{float(mean_p)} ({p_ms:.4f} ms)")
    if n_bad or float(mean) != float(mean_p):
        fail(f"{tag}: throughput_fn differs from its twin")
    return p_ms


def _phase_v(dev, smi, H):
    """Phase v (module docstring) on ``dev``, every check fatal, with the
    main's helpers in ``H``: returns each wide row's launches on its main
    path, the path's name, ``[max |err|, ms, plain ms, bound]`` (each timed
    on its path's spec and shape), and the int8 rows' launches on this
    slice's main path."""
    import numpy as np
    import torch

    import ngx_torch as nt
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.ops import _build
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams
    from ngx_torch.rl.train import PPOConfig, make_train
    from ngx_torch.vector import throughput_fn

    t_v = time.perf_counter()
    vs = _v_specs(nt)
    lib = _build.load_library()
    v_rows = {}       # row: [max |err|, ms, plain ms, bound]

    def wide_of(sp):
        return bool(lib.ngx_wide_cell(sp.n_items))

    def v_note(row, e, timed=None):
        r = v_rows.setdefault(row, [0.0, None, None, None])
        r[0] = max(r[0], e)
        if timed is not None:
            r[1:] = timed

    rs_v = np.random.RandomState(SEED % 2 ** 31 + 5)
    edge_ms = {}
    for name in ("39 ids", "70 ids", "140 ids", "NOOP", "64 ids", "65 ids"):
        sp = vs[name]
        edge = name in ("64 ids", "65 ids")
        for source in ("prng",) if edge else ("input", "prng"):
            acts = None
            if source == "input":
                acts = torch.as_tensor(rs_v.randint(sp.n_actions,
                                                    size=(T, B)),
                                       dtype=torch.int32, device=dev)
            out_k = R.rollout(sp, B, T, SEED, ROLLOUT_BLOCK, source, acts,
                              device=dev)
            out_p, p_ms = H.sync_ms(lambda: R.rollout_plain(
                sp, B, T, SEED, ROLLOUT_BLOCK, source, acts, device=dev))
            same = H.compare_states(out_k[0], out_p[0]) \
                & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
            e = float((out_k[1] - out_p[1]).abs().max())
            print(f"[v] {source} on {name} ({sp.n_items} item ids, the "
                  f"largest on a map {int(out_k[0].map.max())}) B={B} T={T}"
                  f": {int((~same).sum())} envs differ from the twin "
                  f"({p_ms:.4f} ms)")
            if not bool(same.all()):
                fail(f"[v] {source} on {name}: the kernel differs from its "
                     "twin")
            if edge:
                edge_ms[name, "prng"] = H.device_ms(lambda: R.rollout(
                    sp, B, T, SEED, ROLLOUT_BLOCK, "prng", device=dev))
            if (name, source) == ("70 ids", "input"):
                ms = H.device_ms(lambda: R.rollout(
                    sp, B, T, SEED, ROLLOUT_BLOCK, source, acts, device=dev))
                v_note("rollout:input:wide", e,
                       [ms, p_ms, H.bound(sp, [], B, T, source)])
            elif wide_of(sp):
                v_note(f"rollout:{source}:wide", e)
        if edge:
            continue
        n_v = B * POOL_R
        pool_k = R.pool_reset(sp, n_v, SEED + 7, device=dev)
        pool_p, p_ms = H.sync_ms(lambda: reset_rows(
            ResetTables(sp), SEED + 7, 0, torch.arange(n_v, device=dev)))
        same = H.compare_states(pool_k, pool_p, n_v)
        draw_ms = H.device_ms(lambda: R.pool_reset(sp, n_v, SEED + 7,
                                                 device=dev))
        print(f"[v] {smi}: the pool draw on {name} ({n_v} resets at T 0): "
              f"{int((~same).sum())} rows differ from reset_rows on the card"
              f"; {draw_ms:.4f} ms, reset_rows {p_ms:.4f} ms")
        if not bool(same.all()):
            fail(f"[v] the pool draw on {name} differs from reset_rows")
        if wide_of(sp):
            v_note("rollout:prng:wide", 0.0)
    # throughput_fn's launch (70 ids, T 1,024, blocks of 512) by its device
    # time, here, where the main path's counts are not yet set to 0
    tp_dev = H.device_ms(lambda: R.rollout(vs["70 ids"], B, RATE_T, SEED,
                                           512, "prng", device=dev))
    fence_id = vs["70 ids + fence"].items.index("oak_fence")
    for name in ("39 ids", "70 ids + fence", "140 ids",
                 "140 ids, no reset edits", "NOOP", "64 ids", "65 ids"):
        sp = vs[name]
        dims_v = [H.obs_dim_of(sp), *HIDDEN, sp.n_actions]
        lay = H.policy_layers(sp, HIDDEN, SEED)
        start = nt.counter_reset(sp, SEED, 0, B, device=dev)
        start = start.replace(step_count=torch.as_tensor(
            CAP - rs_v.choice(V_CLOCKS, size=B), dtype=torch.int32,
            device=dev))
        _, _, e, out_k, p_ms = H.check_train_kernel(
            f"[v] {name}", sp, H.block, start=start, layers=lay)
        if name == "70 ids + fence":
            fenced = int((out_k[0].map == fence_id).any(1).sum())
            high = int((out_k[0].map >= 64).any(1).sum())
            print(f"[v] after the native resets on {name} (the fence "
                  f"edit over cells holding ids past 63; the additems "
                  f"leave it little air to fence): {fenced} maps hold a "
                  f"fence, {high} hold an id past 63")
            if not high:
                fail("[v] no id past 63 on a map after the fence reset")
        if name in ("140 ids, no reset edits", "64 ids", "65 ids"):
            ms = H.event_ms(lambda: TR.train_rollout(sp, start, lay, SEED, T,
                                                   block=H.block, cap=CAP))
            edge_ms[name, "native"] = ms
        if name == "140 ids, no reset edits":
            v_note("train_rollout:native:wide", e,
                   [ms, p_ms, H.bound(sp, dims_v, B, T, "train")])
        elif wide_of(sp):
            v_note("train_rollout:native:wide", e)
        if name in ("140 ids, no reset edits", "64 ids", "65 ids"):
            continue
        pool_v = R.pool_reset(sp, B * POOL_R, SEED + 1, device=dev)
        _, _, e, out_k, p_ms = H.check_train_kernel(
            f"[v] {name} pool", sp, H.block, cap=POOL_CAP, pool=pool_v,
            layers=lay)
        if name == "140 ids":
            zero = torch.zeros(B, dtype=torch.int32, device=dev)
            st_v = nt.counter_reset(sp, SEED, 0, B, device=dev)
            ms = H.event_ms(lambda: TR.train_rollout(
                sp, st_v, lay, SEED, T, block=H.block, cap=POOL_CAP,
                pool=pool_v, base=zero))
            v_note("train_rollout:pool:wide", e,
                   [ms, p_ms, H.bound(sp, dims_v, B, T, "train", B * POOL_R)])
        elif wide_of(sp):
            v_note("train_rollout:pool:wide", e)
    print(f"[v] {smi}: the last int8 and the first int16 spec (64 and 65 "
          f"item ids, {V_EDGE_ADDS[0]} and {V_EDGE_ADDS[1]} reset edits), "
          f"B={B} T={T}: 'prng' device ms "
          f"{edge_ms['64 ids', 'prng']:.4f} / {edge_ms['65 ids', 'prng']:.4f}"
          f"; the train kernel with native resets (each env reset once), "
          f"events {edge_ms['64 ids', 'native']:.4f} / "
          f"{edge_ms['65 ids', 'native']:.4f}; 140 ids without reset edits "
          f"{edge_ms['140 ids, no reset edits', 'native']:.4f}")
    lay_v, pol_k = {}, {}
    for name in ("70 ids", "140 ids", "NOOP"):
        sp = vs[name]
        lay_v[name] = lay = H.policy_layers(sp, HIDDEN, SEED + 2)
        pol_k[name] = out_k = R.rollout(sp, B, T, SEED, POLICY_BLOCK,
                                        "policy", pi_layers=lay, device=dev)
        seeds, rows = block_streams(SEED, B, POLICY_BLOCK, dev)
        start = reset_rows(ResetTables(sp), seeds, 0, rows)
        out_t = TR.train_rollout(sp, start, lay, SEED, T, block=POLICY_BLOCK,
                                 cap=2 ** 30)
        rsum_t = torch.zeros(B, dtype=torch.float32, device=dev)
        for t in range(T):
            rsum_t = rsum_t + out_t[3][t]
        same_t = H.compare_states(out_k[0], out_t[0]) & (out_k[1] == rsum_t) \
            & (out_k[2] == out_t[4].sum(0))
        out_p, p_ms = H.sync_ms(lambda: R.rollout_plain(
            sp, B, T, SEED, POLICY_BLOCK, "policy", pi_layers=lay,
            device=dev))
        same_p = H.compare_states(out_k[0], out_p[0]) \
            & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
        share_p = int((~same_p).sum()) / B
        print(f"[v] policy on {name} B={B} T={T}: against train_rollout "
              f"(cap 2^30) {int((~same_t).sum())} envs differ; against the "
              f"twin {share_p:.5%} ({p_ms:.4f} ms)")
        if not bool(same_t.all()):
            fail(f"[v] policy on {name} differs from the train kernel")
        if share_p > MAX_MISMATCH_SHARE:
            fail(f"[v] policy on {name}: {share_p:.3%} of envs differ from "
                 "the twin")
        if wide_of(sp):
            e = float((out_k[1] - out_p[1]).abs()[same_p].max())
            timed = None
            if name == "140 ids":
                ms = H.device_ms(lambda: R.rollout(
                    sp, B, T, SEED, POLICY_BLOCK, "policy", pi_layers=lay,
                    device=dev))
                timed = [ms, p_ms, H.bound(sp, [H.obs_dim_of(sp), *HIDDEN,
                                                sp.n_actions], B, T,
                                           "policy")]
            v_note("rollout:policy:wide", e, timed)
    # the main paths, counted, each launch held against its twin on the same
    # inputs: make_train('auto') on the 39-item spec (3 steps: the pool
    # kernel and its draws, int8 cells), on the 140 (one step: the pool
    # kernel and its draw, int16 cells) and on the 140 without reset edits
    # (one step: native), make_rollout 'input' on the 70, throughput_fn on
    # the 70 at T 1,024 (by CUDA events) and make_rollout 'policy' on the
    # 140
    _sync(dev)
    for counter in (TR.train_rollout.launches, TR.train_rollout.wide_launches,
                    R.rollout.launches, R.rollout.wide_launches):
        counter.update(dict.fromkeys(counter, 0))
    R.pool_reset.launches = 0
    with _v_held(H, "[v] make_train on 39 ids") as held:
        init_v, step_v = make_train(PPOConfig(num_envs=B),
                                    spec_override=_u_wide(nt), device=dev)
        carry_v = init_v(SEED)
        for u in range(3):
            carry_v, m_v = step_v(carry_v, SEED + u + 1)
            for k in ("pg_loss", "v_loss", "entropy"):
                if not math.isfinite(float(m_v[k])):
                    fail(f"[v] make_train on 39 ids, step {u}: {k} not "
                         "finite")
        _sync(dev)
    n39 = dict(TR.train_rollout.launches)
    draws39 = R.pool_reset.launches
    print(f"[v] main path: make_train(PPOConfig(num_envs={B}), 39-item "
          f"spec, 'auto'): {step_v.rollout_backend}, resets "
          f"{step_v.reset_source}; 3 steps launched train_rollout {n39}, "
          f"{draws39} pool draws, each held against its twin (max |err| "
          f"{max(e for _, e in held)}); last losses "
          f"{ {k: float(m_v[k]) for k in ('pg_loss', 'v_loss')} }")
    if n39 != {"native": 0, "pool": 3} or draws39 != 3 or len(held) != 6 \
            or step_v.rollout_backend != "pallas":
        fail(f"[v] make_train('auto') on 39 ids launched {n39} and "
             f"{draws39} draws, not the pool kernel 3 times")
    for name in ("140 ids", "140 ids, no reset edits"):
        with _v_held(H, f"[v] make_train on {name}") as held:
            init_v, step_v = make_train(PPOConfig(num_envs=B),
                                        spec_override=vs[name], device=dev)
            _, m_v = step_v(init_v(SEED), SEED + 1)
        if not math.isfinite(float(m_v["pg_loss"])) or not held:
            fail(f"[v] make_train on {name}: {m_v}")
        print(f"[v] main path: make_train on {name}: resets "
              f"{step_v.reset_source}, one step, pg_loss "
              f"{float(m_v['pg_loss'])}, {len(held)} launches held")
        v_note("train_rollout:pool:wide" if step_v.reset_source == "pool"
               else "train_rollout:native:wide", max(e for _, e in held))
    acts = torch.as_tensor(rs_v.randint(vs["70 ids"].n_actions, size=(T, B)),
                           dtype=torch.int32, device=dev)
    st_in, mean_in, n_in = R.make_rollout(
        vs["70 ids"], B, T, block=ROLLOUT_BLOCK, action_source="input",
        device=dev)(SEED, acts)
    out_p = R.rollout_plain(vs["70 ids"], B, T, SEED, ROLLOUT_BLOCK, "input",
                            acts, device=dev)
    if not bool(H.compare_states(st_in, out_p[0]).all()) or \
            int(n_in) != int(out_p[2].sum()) or \
            float(mean_in) != float(out_p[1].sum() / (B * T)):
        fail("[v] make_rollout('input') on 70 ids differs from its twin")
    run_v = throughput_fn(vs["70 ids"], B, RATE_T, device=dev)
    tp_state, tp_mean = run_v(SEED)
    tp_plain = _v_hold_throughput(H, "[v] throughput_fn on 70 ids",
                                  vs["70 ids"], RATE_T, tp_state, tp_mean)
    tp_ms = H.event_ms(lambda: run_v(SEED))
    v_note("rollout:prng:wide", 0.0,
           [tp_dev, tp_plain, H.bound(vs["70 ids"], [], B, RATE_T, "prng")])
    st_pol, _, n_pol = R.make_rollout(
        vs["140 ids"], B, T, block=POLICY_BLOCK, action_source="policy",
        pi_layers=lay_v["140 ids"], device=dev)(SEED)
    if not bool(H.compare_states(st_pol, pol_k["140 ids"][0]).all()) or \
            int(n_pol) != int(pol_k["140 ids"][2].sum()):
        fail("[v] make_rollout('policy') on 140 ids differs from the launch "
             "held against its twin")
    _sync(dev)
    v_launch = {"train_rollout:native:wide":
                TR.train_rollout.wide_launches["native"],
                "train_rollout:pool:wide":
                TR.train_rollout.wide_launches["pool"],
                "rollout:prng:wide": R.rollout.wide_launches["prng"],
                "rollout:input:wide": R.rollout.wide_launches["input"],
                "rollout:policy:wide": R.rollout.wide_launches["policy"]}
    v_paths = {
        "train_rollout:native:wide": "make_train(140 ids, no reset edits)",
        "train_rollout:pool:wide": "make_train(140 ids)",
        "rollout:prng:wide": "make_train(140 ids) pool draw + "
                             "throughput_fn(70 ids, T 1,024)",
        "rollout:input:wide": "make_rollout(70 ids, 'input')",
        "rollout:policy:wide": "make_rollout(140 ids, 'policy')"}
    v_int8 = {"train_rollout:pool": {"make_train(39 ids, 'auto')":
                                     n39["pool"]},
              "rollout:prng": {"make_train(39 ids, 'auto') pools": draws39}}
    print(f"[v] {smi}: throughput_fn on 70 ids B={B} T={RATE_T}: "
          f"{tp_ms:.4f} ms a call (CUDA events), "
          f"{B * RATE_T / tp_ms * 1e3:.1f} env-steps/s, its launch "
          f"{tp_dev:.4f} ms device time; make_rollout 'input' on 70 ids and "
          f"'policy' on 140 equal their held runs; wide launches {v_launch}")
    print(f"[v] {smi}: phase v took {time.perf_counter() - t_v:.3f} s "
          "(phase timer, host clock)")
    return v_launch, v_paths, v_rows, v_int8


# phase w: the tile kernels' reset phase on reset-heavy tiles — (spec, mode,
# cap, envs, RNG block); cap 1 ends every env's episode on every step
W_TRAIN = (("Pogostick-v1", "native", 1, B, None),
           ("fence medium", "pool", 1, B, None),
           ("v3", "native", 3, B, None), ("Pogostick-v0", "native", 3, B, None),
           ("fence hard + additem", "native", 3, B, None),
           ("fence hard + additem", "pool", 3, B, None),
           ("64 ids", "native", 3, B, None),
           ("v3", "native", 3, RAGGED_B, RAGGED_BLOCK))
W_POLICY = (("v3", B, POLICY_BLOCK), ("fence hard + additem", B, POLICY_BLOCK),
            ("64 ids", B, POLICY_BLOCK), ("v3", RAGGED_B, RAGGED_BLOCK))


def _phase_w(dev, smi, H):
    """Phase w (module docstring) on ``dev``, every check fatal, with the
    main's helpers in ``H``."""
    import numpy as np
    import torch

    import ngx_torch as nt
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams

    t_w = time.perf_counter()
    pogo = nt.make_spec(POGO)
    wide = pogo
    for k in range(V_EDGE_ADDS[0]):
        wide = nt.inject_novelty(wide, "additem", "easy", f"thing{k}")
    specs = {k: nt.lidar_in_front(v) for k, v in {
        "Pogostick-v1": pogo,
        "fence medium": nt.inject_novelty(pogo, "fence", "medium", "oak"),
        "v3": nt.make_spec("NovelGridworld-v3"),
        "Pogostick-v0": nt.make_spec("NovelGridworld-Pogostick-v0"),
        "fence hard + additem": nt.inject_novelty(
            nt.inject_novelty(pogo, "fence", "hard", "oak"), "additem",
            "easy", "thing0"),
        "64 ids": wide}.items()}
    lay = {k: H.policy_layers(sp, HIDDEN, SEED + 3) for k, sp in specs.items()}
    rs = np.random.RandomState(SEED % 2 ** 31 + 13)
    for name, mode, cap, n, block in W_TRAIN:
        sp, block = specs[name], block or H.block
        state = nt.counter_reset(sp, SEED, 0, n, device=dev)
        clock = torch.as_tensor(rs.randint(0, cap, n), dtype=torch.int32,
                                device=dev)
        kw = dict(block=block, cap=cap)
        if mode == "pool":
            base = torch.as_tensor(rs.randint(0, 5, n), dtype=torch.int32,
                                   device=dev)
            clock = clock + base
            kw.update(pool=R.pool_reset(sp, n * POOL_R, SEED + 1,
                                        device=dev), base=base)
        state = state.replace(step_count=clock)
        out_k = TR.train_rollout(sp, state, lay[name], SEED, T, **kw)
        out_p, p_ms = H.sync_ms(lambda: TR.train_rollout_plain(
            sp, state, lay[name], SEED, T, **kw))
        tag = f"[w] {name} {mode} cap {cap} B={n}"
        H.check_agreement(tag, sp, out_k, out_p, lay[name], block, cap,
                          "pool restores" if mode == "pool" else
                          "native resets", f"plain twin ({p_ms:.4f} ms)",
                          n=n)
        if cap == 1 and not bool(out_k[4].all()):
            fail(f"{tag}: an env did not end its episode on every step")
    ms_cap1 = H.event_ms(lambda: TR.train_rollout(
        specs["Pogostick-v1"], nt.counter_reset(specs["Pogostick-v1"], SEED,
                                                0, B, device=dev),
        lay["Pogostick-v1"], SEED, T, block=H.block, cap=1))
    for name, n, block in W_POLICY:
        sp = specs[name]
        out_k = R.rollout(sp, n, T, SEED, block, "policy",
                          pi_layers=lay[name], device=dev)
        seeds, rows = block_streams(SEED, n, block, dev)
        start = reset_rows(ResetTables(sp), seeds, 0, rows)
        out_t = TR.train_rollout(sp, start, lay[name], SEED, T, block=block,
                                 cap=2 ** 30)
        rsum_t = torch.zeros(n, dtype=torch.float32, device=dev)
        for t in range(T):
            rsum_t = rsum_t + out_t[3][t]
        same_t = H.compare_states(out_k[0], out_t[0], n) \
            & (out_k[1] == rsum_t) & (out_k[2] == out_t[4].sum(0))
        out_p, p_ms = H.sync_ms(lambda: R.rollout_plain(
            sp, n, T, SEED, block, "policy", pi_layers=lay[name],
            device=dev))
        same_p = H.compare_states(out_k[0], out_p[0], n) \
            & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
        share_p = int((~same_p).sum()) / n
        print(f"[w] policy on {name} B={n} T={T} block={block}: "
              f"{int(out_k[2].sum())} done resets; against train_rollout "
              f"(cap 2^30) {int((~same_t).sum())} envs differ; against the "
              f"twin {share_p:.5%} ({p_ms:.4f} ms)")
        if not bool(same_t.all()):
            fail(f"[w] policy on {name} differs from the train kernel")
        if share_p > MAX_MISMATCH_SHARE:
            fail(f"[w] policy on {name}: {share_p:.3%} of envs differ from "
                 "the twin")
    print(f"[w] {smi}: the train kernel with native resets on Pogostick-v1 "
          f"at cap 1 (every env of every tile reset on every step) B={B} "
          f"T={T}: {ms_cap1:.4f} ms (events)")
    print(f"[w] {smi}: phase w took {time.perf_counter() - t_w:.3f} s "
          "(phase timer, host clock)")


X_BITS, X_KEY_SEED = 2 ** 20, 20261017


def _x_rows(a, b, n):
    """Envs of ``n`` whose state, or obs, differ between two runs (on two
    devices): bool ``[n]`` on the CPU."""
    import torch

    bad = torch.zeros(n, dtype=torch.bool)
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        bad |= (x.reshape(n, -1) != y.reshape(n, -1)).any(dim=1)
    return bad


def _phase_x(dev, smi, H):
    """Phase x (module docstring) on ``dev`` against the CPU, every check
    fatal, with the main's helpers in ``H``."""
    import numpy as np
    import torch

    import ngx_torch as nt
    from ngx_torch.ops import native_reset as NR
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.vector import throughput_fn

    t_x = time.perf_counter()
    cpu = torch.device("cpu")
    key = TF.key(X_KEY_SEED)
    card, host = (TF.bits(key.to(d), (X_BITS,)).cpu() for d in (dev, cpu))
    n_bits = int((card != host).sum())
    print(f"[x] threefry bits of {X_BITS} counters, card against CPU: "
          f"{n_bits} differ")
    if n_bits:
        fail(f"[x] {n_bits} threefry words differ between the card and CPU")
    k = torch.arange(2 ** 23, dtype=torch.int64, device=dev)
    u = torch.maximum(
        torch.tensor(TF._TINY_F32, device=dev),
        ((k | TF._ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0)
        + TF._TINY_F32)
    g = -torch.log(-torch.log(u))
    if not bool((g[1:] > g[:-1]).all()):
        fail("[x] the card's Gumbel scores are not strictly increasing in u")
    print("[x] Gumbel -log(-log(u)) on the card: strictly increasing over "
          "all 2^23 uniforms")

    pogo = nt.make_spec(POGO)
    specs = {"Pogostick-v1": nt.lidar_in_front(pogo),
             "fence medium": nt.lidar_in_front(nt.inject_novelty(
                 pogo, "fence", "medium", "oak",
                 rng=np.random.RandomState(0)))}
    keys = TF.split(TF.key(X_KEY_SEED + 1), B)
    def launches():
        return (sum(TR.train_rollout.launches.values())
                + sum(R.rollout.launches.values()) + R.pool_reset.launches)

    def zero_counts():
        TR.train_rollout.launches.update(
            dict.fromkeys(TR.train_rollout.launches, 0))
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        R.pool_reset.launches = 0

    for name, sp in specs.items():
        reset_c = nt.make_reset(sp, device=dev)
        zero_counts()
        before = NR.native_reset.launches
        (st_c, ob_c), ms1 = H.sync_ms(lambda: reset_c(keys))
        (_, _), ms2 = H.sync_ms(lambda: reset_c(keys))
        want = 2 if dev.type == "cuda" else 0     # none in a CPU rehearsal
        if launches() or NR.native_reset.launches - before != want:
            fail(f"[x] make_reset on {name}: {launches()} rollout or train "
                 f"launches and {NR.native_reset.launches - before} native "
                 f"reset launches in two calls (0 and {want} expected)")
        (st_h, ob_h), ms_h = H.sync_ms(
            lambda: nt.make_reset(sp, device=cpu)(keys))
        bad = _x_rows(st_c, st_h, B) | (ob_c.cpu() != ob_h).any(dim=1)
        print(f"[x] {smi}: make_reset({name}) B={B}: {int(bad.sum())} rows "
              f"differ, card against CPU; card {ms1:.4f}, {ms2:.4f} ms, CPU "
              f"{ms_h:.4f} ms (host clock after synchronize)")
        if bool(bad.any()):
            fail(f"[x] make_reset on {name}: {int(bad.sum())} rows differ "
                 "between the card and the CPU")

    run_c = throughput_fn(pogo, B, T, action_rng="threefry", device=dev)
    zero_counts()
    before = NR.native_reset.launches
    (st_c, mean_c), ms1 = H.sync_ms(lambda: run_c(X_KEY_SEED))
    (_, _), ms2 = H.sync_ms(lambda: run_c(X_KEY_SEED))
    want = 2 * (1 + T) if dev.type == "cuda" else 0
    if launches() or NR.native_reset.launches - before != want:
        fail(f"[x] throughput_fn('threefry'): {launches()} rollout or train "
             f"launches and {NR.native_reset.launches - before} native reset "
             f"launches in two calls (0 and {want} expected)")
    (st_h, mean_h), ms_h = H.sync_ms(lambda: throughput_fn(
        pogo, B, T, action_rng="threefry", device=cpu)(X_KEY_SEED))
    bad = _x_rows(st_c, st_h, B)
    print(f"[x] {smi}: throughput_fn(Pogostick-v1, 'threefry') B={B} T={T}: "
          f"{int(bad.sum())} rows differ, card against CPU; mean reward "
          f"{float(mean_c)!r} (CPU {float(mean_h)!r}); card {ms1:.4f}, "
          f"{ms2:.4f} ms, CPU {ms_h:.4f} ms (host clock after synchronize)")
    if bool(bad.any()) or float(mean_c) != float(mean_h):
        fail(f"[x] throughput_fn('threefry'): {int(bad.sum())} rows differ "
             "between the card and the CPU, or the mean reward")
    run_k = throughput_fn(pogo, B, T, device=dev)
    ms_k = [H.sync_ms(lambda: run_k(SEED))[1] for _ in range(3)]
    print(f"[x] {smi}: for scale, throughput_fn(Pogostick-v1) on the 'prng' "
          f"kernel (counter draws) B={B} T={T}: "
          f"{', '.join('%.4f' % m for m in ms_k)} ms (host clock after "
          "synchronize)")
    print(f"[x] {smi}: phase x took {time.perf_counter() - t_x:.3f} s "
          "(phase timer, host clock)")


# phase y: the PPO main path on ngx's keys
Y_KEY_SEED, Y_STEPS, Y_XLA_B, Y_EVAL_CAP = 20261018, 3, 1024, 100
Y_SOLVER = "trained_agents_torch/NovelGridworld-Pogostick-v1_solver/best.pt"
# the synchronizing CUDA calls a train step may make: the fewest the
# removed counter-RNG step made on an H100 (4 in pool mode, 5 native); the
# keyed step derives its seeds on the host and made 1 there
Y_MAX_SYNCS = 4


def _y_count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``: returns
    its result and the count of synchronizing CUDA calls it made (a
    device-to-host read, or a blocking host-to-device copy)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _y_ulp(a, b):
    """Max units in the last place between two float32 tensors."""
    import torch

    ia = a.detach().cpu().contiguous().view(torch.int32).to(torch.int64)
    ib = b.detach().cpu().contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _phase_y(dev, smi, H):
    """Phase y (module docstring) on ``dev`` against the CPU, every check
    fatal, with the main's helpers in ``H``.  Returns, per kernel row, the
    keyed main paths' launch counts for the kernels line."""
    import numpy as np
    import torch

    import ngx_torch as nt
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.train_rollout import compare_rollouts
    from ngx_torch.rl import train as TRN
    from ngx_torch.rl.evaluate import make_eval
    from ngx_torch.utils.checkpoint import restore_checkpoint

    t_y = time.perf_counter()
    cpu = torch.device("cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    key = TF.key(Y_KEY_SEED)
    n_perm = B * T
    (card, ms_c), (host, ms_h) = (H.sync_ms(lambda: TF.permutation(
        key.to(d), n_perm)) for d in (dev, cpu))
    bad = int((card.cpu() != host).sum())
    print(f"[y] {smi}: permutation(key, {n_perm}): {bad} values differ, "
          f"card against CPU; card {ms_c:.4f} ms, CPU {ms_h:.4f} ms (host "
          "clock after synchronize)")
    if bad:
        fail(f"[y] permutation at n {n_perm}: {bad} values differ between "
             "the card and the CPU")

    pogo = nt.make_spec(POGO)
    specs = {"Pogostick-v1": None,
             "fence medium": nt.inject_novelty(pogo, "fence", "medium", "oak",
                                               rng=np.random.RandomState(0))}
    # T 64, (64, 64), 4 epochs x 8 minibatches on the card
    cfg = TRN.PPOConfig(num_envs=B, rollout_steps=T)

    def zero_counts():
        TR.train_rollout.launches.update(
            dict.fromkeys(TR.train_rollout.launches, 0))
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        R.pool_reset.launches = 0

    paths = {"train_rollout:native": {}, "train_rollout:pool": {},
             "rollout:prng": {}}
    for name, sp in specs.items():
        init_c, step_c = TRN.make_train(cfg, spec_override=sp, device=dev)
        init_h, _ = TRN.make_train(cfg, spec_override=sp, device=cpu)
        zero_counts()
        carry, ms_init = H.sync_ms(lambda: init_c(key))
        carry_h, ms_init_h = H.sync_ms(lambda: init_h(key))
        n_bad = int(_x_rows(carry[1], carry_h[1], B).sum())
        ob_bad = int((carry[2].cpu() != carry_h[2]).any(dim=1).sum())
        spread = max(_y_ulp(a, b) for a, b in zip(
            carry[0].model.parameters(), carry_h[0].model.parameters()))
        print(f"[y] {smi}: keyed init on {name} B={B}: {n_bad} state rows "
              f"and {ob_bad} obs rows differ, card against CPU; the "
              f"parameters {spread} ulp apart (drawn on the host); card "
              f"{ms_init:.4f} ms, CPU {ms_init_h:.4f} ms (host clock)")
        if n_bad or ob_bad or spread:
            fail(f"[y] the keyed init on {name} differs between the card and "
                 "the CPU")
        seeds, want_seeds = [], []
        step_c.phases = {}
        with _v_held(H, f"[y] keyed make_train on {name}", seeds) as held:
            for u in range(Y_STEPS):
                k_u = TF.fold_in(key, u + 1)
                carry, m = step_c(carry, k_u)
                k_roll, k_upd = TF.split(k_u)
                if step_c.reset_source == "pool":
                    k_seed, k_pool = TF.split(k_roll)
                    want = (TRN.draw_seed(k_seed), TRN.draw_seed(k_pool))
                    want_seeds += [("pool_reset", want[1]),
                                   ("train_rollout", want[0])]
                else:
                    want = (TRN.draw_seed(k_roll), None)
                    want_seeds.append(("train_rollout", want[0]))
                perms_h = TRN.epoch_perms(cfg, k_upd, n_perm, cpu)
                p_bad = sum(int((p.cpu() != q).sum())
                            for p, q in zip(step_c.perms, perms_h))
                if step_c.seeds != want or p_bad:
                    fail(f"[y] keyed step {u} on {name}: seeds "
                         f"{step_c.seeds} against the host's {want}, "
                         f"{p_bad} permutation values differ")
                for k in ("pg_loss", "v_loss", "entropy"):
                    if not math.isfinite(float(m[k])):
                        fail(f"[y] keyed step {u} on {name}: {k} not finite")
            _sync(dev)
        n_tr = dict(TR.train_rollout.launches)
        n_pool = R.pool_reset.launches
        mode = step_c.reset_source
        if seeds != want_seeds or n_tr[mode] != Y_STEPS or \
                sum(n_tr.values()) != Y_STEPS or \
                n_pool != (Y_STEPS if mode == "pool" else 0):
            fail(f"[y] keyed make_train on {name}: launches {n_tr}, pools "
                 f"{n_pool}, seeds at the launches {seeds} against the "
                 f"host's {want_seeds}")
        print(f"[y] main path: make_train(PPOConfig(num_envs={B}), {name}"
              f"): {step_c.rollout_backend}, resets {mode}; "
              f"{Y_STEPS} steps launched train_rollout {n_tr} and {n_pool} "
              f"pool draws, each held against its twin (max |err| "
              f"{max(e for _, e in held)}); every kernel and pool seed and "
              f"permutation the host's derivation from the key")
        at = f"make_train(phase y, {name})"
        paths[f"train_rollout:{mode}"][at] = n_tr[mode]
        if mode == "pool":
            paths["rollout:prng"][f"{at} pools"] = n_pool
        for ph in ("pool", "acting", "permutation", "recompute", "gae",
                   "update"):
            if ph in step_c.phases:
                print(f"[y] {smi}: {name} train step phase {ph}: "
                      f"{['%.6f' % (x * 1e3) for x in step_c.phases[ph]]} "
                      "ms")
        step_c.phases = None
        if dev.type == "cuda":      # a rehearsal on the CPU has no card
            (_, n_sync_c) = _y_count_syncs(lambda: step_c(carry, TF.key(9)))
            print(f"[y] {name}: synchronizing CUDA calls in one train step "
                  f"(set_sync_debug_mode): {n_sync_c}, at most "
                  f"{Y_MAX_SYNCS}")
            if n_sync_c > Y_MAX_SYNCS:
                fail(f"[y] the train step on {name} synchronizes {n_sync_c} "
                     f"times, past {Y_MAX_SYNCS}")

    # the keyed 'xla' step, card against CPU, at B Y_XLA_B
    cfg_x = TRN.PPOConfig(num_envs=Y_XLA_B, rollout_steps=T)
    steps_x = []
    for d in (dev, cpu):
        init_x, step_x = TRN.make_train(cfg_x, rollout_backend="xla",
                                        device=d)
        step_x.keep_rollout, step_x.phases = True, {}
        carry_x = init_x(key)
        zero_counts()
        (carry_x, m_x), ms_x = H.sync_ms(lambda: step_x(carry_x,
                                                       TF.fold_in(key, 1)))
        if d.type == "cuda" and (sum(TR.train_rollout.launches.values())
                                 or sum(R.rollout.launches.values())):
            fail("[y] the keyed 'xla' step launched a kernel")
        steps_x.append((carry_x, m_x, step_x.rollout, ms_x,
                        dict(step_x.phases)))
    (c_c, m_c, r_c, ms_xc, ph_c), (c_h, m_h, r_h, ms_xh, ph_h) = steps_x
    roll_c = (c_c[1].to(cpu),) + tuple(x.cpu() for x in r_c)
    roll_h = (c_h[1],) + tuple(r_h)
    first, bad = compare_rollouts(roll_c, roll_h)
    n_off = int((first < T).sum())
    p_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(c_c[0].model.parameters(),
                                 c_h[0].model.parameters()))
    print(f"[y] {smi}: keyed make_train(rollout_backend='xla') one step at "
          f"B={Y_XLA_B} (cut from {B}: the CPU side's T {T} plain steps and "
          f"update), card against CPU: {n_off} envs with an action mismatch, "
          f"{bad or 'nothing'} differing before one; parameters max |diff| "
          f"{p_diff:.3e}; card {ms_xc:.4f} ms, CPU {ms_xh:.4f} ms")
    for ph in ph_c:
        print(f"[y] {smi}: keyed xla step phase {ph}: card "
              f"{['%.6f' % (x * 1e3) for x in ph_c[ph]]} ms, CPU "
              f"{['%.6f' % (x * 1e3) for x in ph_h.get(ph, [])]} ms")
    if bad or n_off > MAX_MISMATCH_SHARE * Y_XLA_B:
        fail(f"[y] the keyed 'xla' step: {bad}, {n_off} envs off")
    if n_off == 0:
        for a, b in zip(c_c[0].model.parameters(), c_h[0].model.parameters()):
            if not torch.allclose(a.detach().cpu(), b.detach(), rtol=1e-5,
                                  atol=1e-6):
                fail("[y] the keyed 'xla' step's parameters differ between "
                     "the card and the CPU past rtol 1e-5 / atol 1e-6")
        for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum"):
            if float(m_c[k]) != float(m_h[k]):
                fail(f"[y] the keyed 'xla' step's {k} differs")

    # keyed make_eval at EVAL_EPISODES, card against CPU
    solver = restore_checkpoint(os.path.join(root, Y_SOLVER))["params"]
    for who, params in (("random", None), ("Pogostick-v1 solver", solver)):
        got = []
        for d in (dev, cpu):
            run = make_eval(pogo, cap=Y_EVAL_CAP, device=d)
            got.append(H.sync_ms(lambda: run(params, key, EVAL_EPISODES)))
        (mc, ms_ec), (mh, ms_eh) = got
        print(f"[y] {smi}: keyed make_eval({who}) {EVAL_EPISODES} episodes, "
              f"cap {Y_EVAL_CAP}: card {mc}, CPU {mh}; card {ms_ec / 1e3:.3f}"
              f" s, CPU {ms_eh / 1e3:.3f} s")
        if who == "random":
            if mc != mh:
                fail("[y] keyed make_eval (random) differs card against CPU")
        else:
            # at most 1% of episodes may take another path at a Gumbel
            # near-tie (the card's logits round otherwise than the CPU's)
            share = MAX_MISMATCH_SHARE
            lim = {"solve_rate": share, "done_rate": share,
                   "mean_length": share * Y_EVAL_CAP,
                   "mean_return": share * 200.0}
            for k, v in lim.items():
                if abs(mc[k] - mh[k]) > v:
                    fail(f"[y] keyed make_eval (solver) {k}: card {mc[k]}, "
                         f"CPU {mh[k]}")
    print(f"[y] {smi}: phase y took {time.perf_counter() - t_y:.3f} s "
          "(phase timer, host clock)")
    return paths


Z_KEY_SEED, Z_STEPS, Z_POOL, Z_STEP_T = 20261019, 3, 1024, 16


def _z_equal_or_rule(tag, got, want, cap):
    """Evaluation dicts on two devices: equal, or (a policy's actions at a
    Gumbel near-tie) apart by at most MAX_MISMATCH_SHARE of the episodes,
    as phase y holds the solver's."""
    share = MAX_MISMATCH_SHARE
    lim = {"solve_rate": share, "done_rate": share,
           "mean_return": share * 200.0}
    for k, v in lim.items():
        if abs(got[k] - want[k]) > v:
            fail(f"{tag} {k}: card {got[k]}, CPU {want[k]}")
    if set(got) != set(want):
        fail(f"{tag}: the card's keys {sorted(got)}, the CPU's {sorted(want)}")


def _phase_z(dev, smi, H):
    """Phase z (module docstring) on ``dev`` against the CPU, every check
    fatal, with the main's helpers in ``H``.  Returns the keyed chain's
    launch counts for the kernels line and the max |err| of its launches
    held against the twin."""
    import torch

    import ngx_torch as nt
    import ngx_torch.rl.curriculum as CUR
    from ngx_torch import parallel as P
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.rl import train as TRN
    from ngx_torch.rl.bc import load_demos
    from ngx_torch.utils.checkpoint import restore_checkpoint

    t_z = time.perf_counter()
    cpu = torch.device("cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    agents = os.path.join(root, "trained_agents_torch")
    stages = [restore_checkpoint(os.path.join(agents, "chain", e, "best.pt"))
              ["params"] for e in CHAIN[:-1]]
    solver = restore_checkpoint(os.path.join(agents, "chain_solver_v5",
                                             "best.pt"))["params"]
    key = TF.key(Z_KEY_SEED)

    def zero_counts():
        TR.train_rollout.launches.update(
            dict.fromkeys(TR.train_rollout.launches, 0))
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        R.pool_reset.launches = 0

    def launched():
        return (sum(TR.train_rollout.launches.values())
                + sum(R.rollout.launches.values()) + R.pool_reset.launches)

    # ---- 1. the keyed chain, card against CPU ------------------------------
    runs = []
    for d in (dev, cpu):
        chain, _ = CUR.make_chain_reset(CHAIN, stages, Z_POOL, cap=CAP,
                                        device=d)
        zero_counts()
        runs.append(H.sync_ms(lambda: chain(key)))
        if launched():
            fail("[z] the keyed chain launched a kernel")
    ((st_c, ob_c), ms_c), ((st_h, ob_h), ms_h) = runs
    n_bad = int(_x_rows(st_c, st_h, Z_POOL).sum())
    ob_bad = int((ob_c.cpu() != ob_h).any(dim=1).sum())
    print(f"[z] {smi}: keyed make_chain_reset({' -> '.join(CHAIN)}, stage "
          f"agents, P={Z_POOL}, cap {CAP}): {n_bad} state rows and {ob_bad} "
          f"obs rows differ, card against CPU (the rule allows "
          f"{int(MAX_MISMATCH_SHARE * Z_POOL)}); card {ms_c:.4f} ms, CPU "
          f"{ms_h:.4f} ms (host clock after synchronize)")
    if max(n_bad, ob_bad) > MAX_MISMATCH_SHARE * Z_POOL:
        fail(f"[z] the keyed chain: {n_bad} rows differ between the card "
             "and the CPU")

    # ---- 2. three keyed make_train_chain('auto') steps, counted ------------
    cfg = TRN.PPOConfig(env_id=CHAIN[-1], num_envs=B, rollout_steps=T,
                        solve_shaped=True, bc_coef=0.05)
    bc_data = load_demos(os.path.join(root, "demos", f"{CHAIN[-1]}.npz"))
    init, step = CUR.make_train_chain(cfg, CHAIN, stages, bc_data=bc_data,
                                      pool_size=Z_POOL, device=dev)
    carry, ms_init = H.sync_ms(lambda: init(key))
    zero_counts()
    step.phases = {}
    seeds, want_seeds, episodes = [], [], 0
    with _v_held(H, "[z] keyed make_train_chain", seeds,
                 module=CUR) as held:
        for u in range(Z_STEPS):
            k_u = TF.fold_in(key, u + 1)
            carry, m = step(carry, k_u)
            _, k_roll, k_upd = TF.split(k_u, 3)
            k_seed, k_idx = TF.split(k_roll)
            want = (TRN.draw_seed(k_seed), None)
            want_seeds.append(("train_rollout", want[0]))
            rows_h = TF.randint(k_idx, (B, TRN.POOL_SLOTS), 0, Z_POOL)
            r_bad = int((step.pool_rows.cpu() != rows_h).sum())
            perms_h = TRN.epoch_perms(cfg, k_upd, B * T, cpu)
            p_bad = sum(int((p.cpu() != q).sum())
                        for p, q in zip(step.perms, perms_h))
            if step.seeds != want or r_bad or p_bad:
                fail(f"[z] keyed chain step {u}: seeds {step.seeds} against "
                     f"the CPU's {want}, {r_bad} pool rows and {p_bad} "
                     "permutation values differ")
            for k in ("pg_loss", "v_loss", "entropy"):
                if not math.isfinite(float(m[k])):
                    fail(f"[z] keyed chain step {u}: {k} is not finite")
            episodes += int(m["episodes"])
        _sync(dev)
    n_tr = dict(TR.train_rollout.launches)
    n_roll, n_draw = sum(R.rollout.launches.values()), R.pool_reset.launches
    if seeds != want_seeds or n_tr["pool"] != Z_STEPS or n_tr["native"] \
            or n_roll or n_draw:
        fail(f"[z] keyed make_train_chain: train_rollout {n_tr}, rollout "
             f"{n_roll}, pool draws {n_draw}, seeds at the launches {seeds} "
             f"against the CPU's {want_seeds}")
    z_err = max(e for _, e in held)
    n_chain = n_tr["pool"]
    print(f"[z] main path: make_train_chain(PPOConfig(env_id={CHAIN[-1]!r}, "
          f"num_envs={B}, solve_shaped, bc_coef 0.05), stage agents, P="
          f"{Z_POOL}): {step.rollout_backend}; {Z_STEPS} "
          f"steps launched train_rollout {n_tr}, {n_draw} stage-0 draws, "
          f"each launch held against its twin (max |err| {z_err}); every "
          f"kernel seed, pool row and permutation the CPU's derivation from "
          f"the key; {episodes} episodes; init {ms_init:.4f} ms")
    for name, secs in step.phases.items():
        print(f"[z] {smi}: keyed chain train step phase {name}: "
              f"{['%.6f' % (x * 1e3) for x in secs]} ms")

    # ---- 3. one timed refresh_pool ----------------------------------------
    step.phases = {}
    zero_counts()
    carry, ms_ref = H.sync_ms(lambda: step.refresh_pool(
        carry, TF.fold_in(key, 500_000)))
    if launched():
        fail("[z] the keyed refresh_pool launched a kernel")
    print(f"[z] {smi}: keyed refresh_pool (P={Z_POOL}, cap {CAP}, three "
          f"stages): {ms_ref:.4f} ms (host clock after synchronize)")
    carry, m = step(carry, TF.fold_in(key, 4))
    if not math.isfinite(float(m["pg_loss"])):
        fail("[z] the step after refresh_pool: pg_loss is not finite")

    # ---- 4. keyed evaluate_chain, card against CPU -------------------------
    evals = []
    for d in (dev, cpu):
        zero_counts()
        evals.append(H.sync_ms(lambda: CUR.evaluate_chain(
            CHAIN, stages, solver, episodes=EVAL_EPISODES, cap=CAP,
            seed=Z_KEY_SEED, device=d)))
        if launched():
            fail("[z] keyed evaluate_chain launched a kernel")
    (ev_c, ms_ec), (ev_h, ms_eh) = evals
    print(f"[z] {smi}: keyed evaluate_chain(chain_solver_v5) "
          f"{EVAL_EPISODES} episodes, cap {CAP}: card {ev_c}, CPU {ev_h}; "
          f"card {ms_ec / 1e3:.3f} s, CPU {ms_eh / 1e3:.3f} s")
    _z_equal_or_rule("[z] keyed evaluate_chain", ev_c, ev_h, CAP)

    # ---- 5. the mesh's stepping functions on ngx's keys at W 1 -------------
    # v3: random actions end episodes there, so the resets (the wall coin
    # among their edits) are held too
    v3 = nt.make_spec("NovelGridworld-v3")
    stepped = []
    for d in (dev, cpu):
        mesh = P.make_local_meshes(1, d)[0]
        zero_counts()
        (st, mean, done), ms_s = H.sync_ms(lambda: P.sharded_throughput_fn(
            v3, mesh, B, Z_STEP_T, rng="threefry")(key))
        spmd, ms_p = H.sync_ms(lambda: P.make_spmd_rollout(
            v3, mesh, B, Z_STEP_T, rng="threefry")(key))
        packed = P.make_spmd_rollout(v3, mesh, B, Z_STEP_T, packed=True,
                                     rng="threefry")(key) \
            if d.type == "cuda" else spmd
        if launched():
            fail("[z] the keyed stepping functions launched a kernel")
        stepped.append((st, float(mean), int(done), float(spmd[0]),
                        int(spmd[1]), ms_s, ms_p,
                        (float(packed[0]), int(packed[1]))))
    (st_c, mean_c, done_c, sm_c, sd_c, ms_sc, ms_pc, pk_c), \
        (st_h, mean_h, done_h, sm_h, sd_h, ms_sh, ms_ph, _) = stepped
    n_bad = int(_x_rows(st_c, st_h, B).sum())
    print(f"[z] {smi}: keyed sharded_throughput_fn(NovelGridworld-v3, W 1, B={B}"
          f", T={Z_STEP_T}): {n_bad} state rows differ, card against CPU; mean "
          f"{mean_c} / {mean_h}, episodes {done_c} / {done_h}; card "
          f"{ms_sc:.4f} ms, CPU {ms_sh:.4f} ms")
    print(f"[z] {smi}: keyed make_spmd_rollout(W 1): mean {sm_c} / {sm_h}, "
          f"episodes {sd_c} / {sd_h}, packed on the card {pk_c}; card "
          f"{ms_pc:.4f} ms, CPU {ms_ph:.4f} ms")
    if n_bad or done_c != done_h or sd_c != sd_h or not done_c or \
            not math.isclose(mean_c, mean_h, rel_tol=1e-6) or \
            not math.isclose(sm_c, sm_h, rel_tol=1e-6) or \
            pk_c != (sm_c, sd_c):
        fail("[z] the keyed stepping functions differ between the card and "
             "the CPU, or packed from plain")

    # ---- 6. the scaling harness on ngx's keys, W 1 and 2 on the card -----
    from ngx_torch.rl.scaling import measure_scaling

    scaling = measure_scaling((1, 2), per_device_batch=B // 2,
                              rollout_steps=T, mode="fixed-total",
                              device=dev.type, backend="gloo")
    scaling_n = measure_scaling.launches
    print(f"[z] {smi}: measure_scaling((1, 2), 'fixed-total', gloo on one "
          f"card, {B} envs in all, T {T}, make_train(cfg, mesh) "
          f"from key(0), a warm-up and 3 timed steps on "
          f"fold_in(key, 1), (2), ...; the shortest by rank 0's host "
          f"clock): throughput {scaling['throughput']} env-steps/s, "
          f"efficiency {scaling['efficiency']} (not gated); train_rollout "
          f"by mesh and rank {scaling_n}")
    if any(n_r != {"native": 4, "pool": 0}
           for ranks in scaling_n.values() for n_r in ranks) or \
            [len(scaling_n.get(w, ())) for w in (1, 2)] != [1, 2]:
        fail(f"[z] the scaling harness's ranks launched train_rollout "
             f"{scaling_n}")
    print(f"[z] {smi}: phase z took {time.perf_counter() - t_z:.3f} s "
          "(phase timer, host clock)")
    return ({"train_rollout:pool:chain": {
        f"make_train_chain(phase z, {CHAIN[0][-2:]}..{CHAIN[-1][-2:]})":
            n_chain},
        "train_rollout:native": {
            f"measure_scaling(W {w}, rank {k})": n_r["native"]
            for w, ranks in scaling_n.items()
            for k, n_r in enumerate(ranks)}}, z_err)


# the keyed perf CLI (ngx_torch/cli/perf.py on ngx's keys), in process
KP_TRAINER = (("Pogostick-v1", []),
              ("fence medium", ["-novelty", "fence:medium:oak"]))
KP_POLICY_STEPS = 64


def _phase_kp(dev, smi, H):
    """Keyed ``perf`` (module docstring) on ``dev``, every check fatal:
    ``--trainer`` on Pogostick-v1 and fence medium and ``--policy``, each
    run with the launch counts set to 0 just before and read just after,
    each launch held against its plain version on the same inputs.
    Returns the paths' launch counts and the largest error of a held
    launch, per kernel row."""
    import io

    from ngx_torch.cli import perf
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import train_rollout as TR

    t_kp = time.perf_counter()
    quiet = contextlib.redirect_stdout

    def zero_counts():
        TR.train_rollout.launches.update(
            dict.fromkeys(TR.train_rollout.launches, 0))
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        R.pool_reset.launches = 0

    def json_line(text):
        return json.loads(text.strip().splitlines()[-1])

    paths = {"train_rollout:native": {}, "train_rollout:pool": {},
             "rollout:prng": {}, "rollout:policy": {}}
    err = dict.fromkeys(paths, 0.0)
    for name, extra in KP_TRAINER:
        argv = ["--trainer", "-batch", str(B), "-repeats", "1",
                "-device", str(dev)] + extra
        tag = f"[kp] perf {' '.join(argv)}"
        out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with _v_held(H, tag) as held:
            with quiet(out):
                perf.main(argv)
            _sync(dev)
            secs = time.perf_counter() - t0
            n_tr = dict(TR.train_rollout.launches)
            n_pool = R.pool_reset.launches
            n_roll = sum(R.rollout.launches.values())
        mode = "pool" if extra else "native"
        n_held = sum(what == "pool_reset" for what, _ in held)
        # the kernel side's warm-up, timed and by-phase steps (a pool draw,
        # a 'prng' launch at T 0, before each in pool mode); the unfused
        # loop launches nothing (a rehearsal on the CPU launches nothing)
        if len(held) != 3 + n_held or n_held != (3 if extra else 0) or (
                dev.type == "cuda" and (
                    n_tr[mode] != 3 or sum(n_tr.values()) != 3
                    or n_pool != n_held or n_roll != n_pool)):
            fail(f"{tag}: launches {n_tr}, pool draws {n_pool}, rollout "
                 f"launches {n_roll}, {len(held)} held")
        for what, e in held:
            row = ("rollout:prng" if what == "pool_reset"
                   else f"train_rollout:{mode}")
            err[row] = max(err[row], e)
        res = json_line(out.getvalue())
        for k in ("train_step_xla", "train_step_pallas"):
            if not res["steps_per_s"].get(k, 0) > 0:
                fail(f"{tag}: no rate for {k}: {res}")
        print(f"[kp] {smi}: {tag[5:]}: {secs:.3f} s; train_rollout {n_tr}, "
              f"{n_pool} pool draws, each held against its twin (max |err| "
              f"{max(e for _, e in held)}); ms {res['ms']}; by phase "
              f"{res['phases_ms']}")
        at = f"perf --trainer{' ' + ' '.join(extra) if extra else ''} (keys)"
        paths[f"train_rollout:{mode}"][at] = n_tr[mode]
        if n_pool:
            paths["rollout:prng"][f"{at} pools"] = n_pool

    # --policy: ngx's weights from key(1); each launch held against the twin
    argv = ["--policy", "-batch", str(B), "-steps", str(KP_POLICY_STEPS),
            "--no-twin", "-device", str(dev)]
    tag = f"[kp] perf {' '.join(argv)}"
    real, kept = R.rollout, []

    def rollout(spec, batch, steps, seed, block, source, *a, **kw):
        got = real(spec, batch, steps, seed, block, source, *a, **kw)
        kept.append((spec, batch, steps, seed, block, source, a, kw,
                     _v_copy(got)))
        return got

    rollout.launches = real.launches
    rollout.wide_launches = real.wide_launches
    rollout.widened = real.widened
    out = io.StringIO()
    zero_counts()
    R.rollout = rollout
    try:
        t0 = time.perf_counter()
        with quiet(out):
            perf.main(argv)
        _sync(dev)
        secs = time.perf_counter() - t0
    finally:
        R.rollout = real
    n_pol = R.rollout.launches["policy"]
    if len(kept) < 2 or any(k[5] != "policy" for k in kept) or (
            dev.type == "cuda" and (
                n_pol != len(kept)
                or sum(R.rollout.launches.values()) != n_pol)):
        fail(f"{tag}: launches {dict(R.rollout.launches)}, {len(kept)} "
             "calls kept")
    spec, batch, steps, seed, block, _, a, kw, _ = kept[0]
    layers = a[1] if len(a) > 1 else kw["pi_layers"]
    (out_p, p_ms) = H.sync_ms(lambda: R.rollout_plain(
        spec, batch, steps, seed, block, "policy", pi_layers=layers,
        device=dev))
    shares = []
    for k in kept:
        if k[3] != seed:
            fail(f"{tag}: launches on seeds {seed} and {k[3]}")
        out_k = k[-1]
        same = H.compare_states(out_k[0], out_p[0], batch) & \
            (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
        shares.append(int((~same).sum()) / batch)
        if bool(same.any()):
            err["rollout:policy"] = max(err["rollout:policy"], float(
                (out_k[1] - out_p[1]).abs()[same].max()))
    res = json_line(out.getvalue())
    print(f"[kp] {smi}: {tag[5:]}: {secs:.3f} s; {n_pol} 'policy' launches "
          f"(B {batch}, T {steps}, block {block}, kernel seed {seed}), "
          f"each against the twin on the same inputs: envs differing "
          f"{['%.5f%%' % (x * 100) for x in shares]} (twin {p_ms:.4f} ms); "
          f"ms {res['ms']}")
    if max(shares) > MAX_MISMATCH_SHARE:
        fail(f"{tag}: {max(shares):.3%} of envs differ from the twin")
    paths["rollout:policy"]["perf --policy (keys)"] = n_pol
    print(f"[kp] {smi}: phase kp took {time.perf_counter() - t_kp:.3f} s "
          "(phase timer, host clock)")
    return paths, err


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
    from ngx_torch.core.reset import (ResetTables, native_reset_plain,
                                      reset_rows)
    from ngx_torch.cli.kernel_ab import ptxas_lines
    from ngx_torch.cli.perf import kernel_device_ms, launch_event_ms
    from ngx_torch.ops import _build
    from ngx_torch.ops import native_reset as NR
    from ngx_torch.ops import rollout as R
    from ngx_torch.ops import threefry as TF
    from ngx_torch.ops import train_rollout as TR
    from ngx_torch.ops.rng import block_streams
    from ngx_torch.ops.tables import c_ints, has_novelty, kernel_tables
    from ngx_torch.rl.bc import load_demos
    from ngx_torch.rl.curriculum import (evaluate_chain, make_chain_reset,
                                         make_train_chain)
    from ngx_torch.rl.evaluate import evaluate_checkpoint, make_eval
    from ngx_torch.rl.models import ActorCritic
    from ngx_torch.rl.train import PPOConfig, make_train, pick_trainer_block
    from ngx_torch.utils.checkpoint import restore_checkpoint
    from ngx_torch.vector import throughput_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_main = time.perf_counter()

    def stamp(phase):
        """The host-clock seconds since main began, at a phase's start."""
        print(f"[time] phase {phase} starts at "
              f"{time.perf_counter() - t_main:.3f} s")

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
        """Mean device time of the rollout kernel per launch over ``reps``
        calls of ``fn`` (one launch each): by torch.profiler over the
        launches it recorded, or by CUDA events around each launch where
        the profiler recorded none (``cli/perf.py`` kernel_device_ms)."""
        ms, n, source = kernel_device_ms(fn, reps)
        if ms is None:
            fail("no device time for rollout_kernel, by profiler or events")
        if source != "profiler":
            print(f"[device time] torch.profiler recorded no rollout_kernel "
                  f"launch; {n} of {reps} launches timed by CUDA events")
        elif n != reps:
            print(f"[profiler] recorded {n} of {reps} rollout_kernel launches")
        return ms

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
        model = ActorCritic.from_key(TF.key(seed), obs_dim, spec.n_actions,
                                     hidden).to(dev)
        return [(w.detach(), b.detach()) for w, b in model.pi_layers()]

    stamp("2")
    # ---- 2. build ---------------------------------------------------------
    path, secs, log = _build.build()
    ptxas = ptxas_lines(log)      # {kernel: its registers and spills lines}
    print(f"[2] built {os.path.relpath(path)} from "
          f"{' + '.join(_build.SOURCES)} (one nvcc each, in parallel), "
          f"{secs:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    stamp("3")
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
        mode = "pool restores" if pool is not None else "native resets"
        max_abs_err = check_agreement(tag, spec, out_k, out_p, layers, block,
                                      cap, mode, "plain twin")
        return state, layers, max_abs_err, out_k, p_ms

    def check_agreement(tag, spec, out_k, out_p, layers, block, cap, mode,
                        other, seed=SEED, need_done=True, n=B):
        """Phase 3's rule: the kernel's rollout ``out_k`` of ``n`` envs
        against ``out_p`` from the same state, weights and ``seed``,
        everything equal per env up to its first action mismatch, at most 1%
        of envs with one, each at a near-tie of the Gumbel score; returns
        the max |err| in the compared prefix.  ``need_done``: fail where no
        episode ends."""
        first, bad = TR.compare_rollouts(out_k, out_p)
        if bad:
            fail(f"{tag}: kernel and {other} disagree inside the compared "
                 f"prefix: {bad}")
        mism = (first < T).nonzero()[:, 0]
        share = mism.numel() / n
        # every first mismatch must sit at a near-tie of the other's Gumbel
        # score
        seeds, rows = block_streams(seed, n, block, dev)
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
        print(f"{tag} kernel vs {other} on {spec.env_id} {spec.novelty_tag} "
              f"at B={n} T={T} block={block} cap={cap}: {n_done} dones "
              f"({mode}), "
              f"{mism.numel()} envs with an action mismatch ({share:.5%}), "
              f"top-2 Gumbel gap at a mismatch <= {max_gap:.3g}, "
              f"max |err| in the compared prefix {max_abs_err}")
        if n_done == 0 and need_done:
            fail(f"{tag}: no episode boundary inside the compared rollout")
        if share > MAX_MISMATCH_SHARE:
            fail(f"{tag}: {share:.3%} of envs mismatch "
                 f"(limit {MAX_MISMATCH_SHARE:.0%})")
        if max_gap >= GUMBEL_TIE_GAP:
            fail(f"{tag}: an action mismatch at a Gumbel gap of {max_gap} "
                 "(not a tie)")
        return max_abs_err

    spec = nt.lidar_in_front(nt.make_spec(POGO))
    block = pick_trainer_block(B)
    state, layers, max_abs_err, _, _ = check_train_kernel("[3]", spec, block)
    obs_dim = layers[0][0].shape[1]

    stamp("4")
    # ---- 4. the main path: 3 PPO train steps through the kernel -----------
    # on ngx's keys, as ngx's train: the init on key(SEED), update u on
    # fold_in(key, u + 1)
    cfg = PPOConfig(num_envs=B)
    init, train_step = make_train(cfg, device=dev)
    key = TF.key(SEED)
    carry = init(key)
    count0 = carry[1].step_count.clone()
    torch.cuda.synchronize()
    TR.train_rollout.launches.update(native=0, pool=0)
    step_s = []
    for u in range(3):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, TF.fold_in(key, u + 1))
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

    stamp("5")
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

    stamp("a")
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

    stamp("b")
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
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
    st_m, mean_m = throughput_fn(pogo, B, T, device=dev)(SEED)
    torch.cuda.synchronize()
    launches_prng = R.rollout.launches["prng"]
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
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

    stamp("c")
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
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
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

    stamp("d")
    # ---- d. the legacy template through the train kernel ------------------
    v5 = nt.lidar_in_front(nt.make_spec("NovelGridworld-v5"))
    check_train_kernel("[d]", v5, pick_trainer_block(B))

    stamp("f")
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

    stamp("g")
    # ---- g. the main path: PPO on the novelty spec, pool resets ------------
    init_f, step_f = make_train(PPOConfig(num_envs=B), spec_override=fence_m,
                                device=dev)
    carry_f = init_f(key)
    torch.cuda.synchronize()
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
    R.pool_reset.launches = 0
    step_f.phases = {}
    eps = 0
    for u in range(3):
        carry_f, metrics_f = step_f(carry_f, TF.fold_in(key, u + 1))
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
    carry_0 = init_0(key)
    TR.train_rollout.launches.update(native=0, pool=0)
    carry_0, metrics_0 = step_0(carry_0, TF.fold_in(key, 1))
    torch.cuda.synchronize()
    print(f"[g] one train step on Pogostick-v0: reset source "
          f"{step_0.reset_source}, train_rollout launches "
          f"{TR.train_rollout.launches}, pg_loss "
          f"{float(metrics_0['pg_loss'])}")
    if step_0.reset_source != "pool" or \
            TR.train_rollout.launches != {"native": 0, "pool": 1}:
        fail("Pogostick-v0 did not train on the pool source")

    stamp("h")
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

    stamp("e")
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

    stamp("i")
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
    for entry, lines in ptxas.items():
        for line in lines:
            print(f"[i] ptxas {entry}: {line}")

    stamp("j")
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
    for entry, lines in ptxas.items():
        if "train_rollout_kernel" in entry or "policy_rollout_kernel" in entry:
            for line in lines:
                print(f"[j] ptxas {entry}: {line}")
    print(f"[j] {smi}: tile-MLP kernels at B={B}: train native "
          f"(Pogostick-v1, T={T}) {kernel_ms:.4f} ms, train pool (fence "
          f"medium) {pool_ms:.4f} ms, policy (T={POLICY_RATE_T}) "
          f"{rate['policy']:.4f} ms device")

    # ---- the kernels' record -------------------------------------------------
    def bound(spec, dims, batch, steps, source, pool_rows=0, words=0):
        """(ms, 'bytes' or 'operations'): the state in and out (``words``
        int32 words an env where it is written packed), the tables, the
        weights, the trajectory ('train'), the action stream ('input'), the
        pool and its bases, each once, over 3.35 TB/s; the MLP's float32
        multiply-adds (2 operations each) over 67 TFLOP/s."""
        hw, ni = spec.map_size ** 2, spec.n_items
        state = batch * (words or hw + 7 + 2 + ni) * 4
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

    stamp("k")
    # ---- k. the warp-redesigned 'prng' / 'input' path ----------------------
    # each run: source, env, novelties, B, block, and the reset lanes the
    # launch must take (None: not checked).  Fence medium at B 65,536 is the
    # launch the residency rule widens (rollout.cu warp_residency: lanes 2,
    # one wave); a random policy ends no episode there within T, so the
    # twin holds its start reset, all 32 envs of a warp in groups of 2.
    firewall = (("firewall", "hard"),)
    fence_medium = (("fence", "medium", "oak"),)
    runs_k = [("prng", "NovelGridworld-v3", (), B, ROLLOUT_BLOCK, None),
              ("prng", POGO, firewall, B, ROLLOUT_BLOCK, None),
              ("prng", POGO, firewall + (("fence", "easy", "oak"),), B,
               ROLLOUT_BLOCK, None),
              ("input", "NovelGridworld-v2", (), B, ROLLOUT_BLOCK, None),
              ("prng", "NovelGridworld-v3", (), RAGGED_B, RAGGED_BLOCK, None),
              ("prng", POGO, fence_medium, RATE_BATCHES[1], ROLLOUT_BLOCK,
               2)]
    rs_k = np.random.RandomState(SEED % 2 ** 31 + 2)
    for source, env_id, novs, bk, blk, want_lanes in runs_k:
        sp = novelty_spec(env_id, novs)
        acts = None
        if source == "input":
            acts = torch.as_tensor(rs_k.randint(sp.n_actions, size=(T, bk)),
                                   dtype=torch.int32, device=dev)
        widened = R.rollout.widened[source]
        out_k = R.rollout(sp, bk, T, SEED, blk, source, acts, device=dev)
        geo = R.launch.geometry
        if want_lanes is not None:
            print(f"[k] {source:5s} {env_id} {sp.novelty_tag} B={bk}: "
                  f"launched {geo}")
            if dev.type == "cuda" and (
                    geo is None or geo["lanes"] != want_lanes
                    or not geo["widened"]
                    or R.rollout.widened[source] != widened + 1):
                fail(f"the residency rule took {geo} on {env_id} "
                     f"{sp.novelty_tag} at B={bk}, not lanes {want_lanes} "
                     "widened")
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
        if n_done == 0 and want_lanes is None:
            fail(f"no episode end on {env_id} {sp.novelty_tag}: the warp "
                 "resets went unchecked")
    for entry, lines in ptxas.items():
        if "14rollout_kernel" in entry:
            for line in lines:
                print(f"[k] ptxas {entry}: {line}")
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
    # the plain and the fenced launch at each batch, each with the geometry
    # the library took (the fenced one widens its reset lanes at B 65,536)
    for sp in (pogo, fence_m):
        for b_rate in RATE_BATCHES:
            run = throughput_fn(sp, b_rate, RATE_T, device=dev)
            ms = device_ms(lambda: run(SEED))
            geo = R.launch.geometry
            b_ms, b_by = bound(sp, [], b_rate, RATE_T, "prng")
            print(f"[k] {smi}: throughput_fn {sp.env_id.split('-', 1)[1]} "
                  f"{sp.novelty_tag} B={b_rate} T={RATE_T}: kernel (device) "
                  f"{ms:.4f} ms = {b_rate * RATE_T / ms * 1e3:.1f} "
                  f"env-steps/s; bound {b_ms:.4f} ms ({b_by}); launched "
                  f"{geo}")
    b_ms, b_by = bound(fence_m, [], n_pool, 0, "prng")
    print(f"[k] {smi}: the pool draw ({n_pool} resets of fence medium at "
          f"T=0): {gen_ms:.4f} ms device time (phase i); bound {b_ms:.4f} "
          f"ms ({b_by})")

    stamp("l")
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
    _, start_l, _, _, base_l, pool_l, _ = init_l(TF.key(SEED))
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
    # the chain's stage-0 draw (make_chain_reset's make_reset: ngx's native
    # reset kernel on the first stage's spec, P rows, over split(k0, P) with
    # k0 the first half of the init's k_env) against its plain twin on the
    # card
    v2 = nt.lidar_in_front(nt.make_spec(CHAIN[0]))
    n_draw = pool_l.batch
    keys_d = TF.split(TF.split(TF.split(TF.key(SEED), 3)[0])[0],
                      n_draw).to(dev)
    reset_v2 = nt.make_reset(v2, dev)
    draw = reset_v2(keys_d)[0]
    draw_p = native_reset_plain(ResetTables(v2), keys_d)
    same = compare_states(draw, draw_p, n_draw)
    draw_err = max(float((x.long() - getattr(draw_p, name).long()).abs()
                         .max()) for name, x in draw.__dict__.items())
    draw_ms = event_ms(lambda: reset_v2(keys_d))
    draw_plain_ms = event_ms(lambda: native_reset_plain(ResetTables(v2),
                                                        keys_d))
    print(f"[l] {smi}: the chain's stage-0 draw ({n_draw} native resets of "
          f"{CHAIN[0]} from the init's key) vs its plain twin on the card: "
          f"{int((~same).sum())} rows differ, max |err| {draw_err}; "
          f"{draw_ms:.4f} ms by events, the twin {draw_plain_ms:.4f} ms")
    if not bool(same.all()):
        fail("the chain's stage-0 draw differs from its plain twin")
    # the chain of the first env alone plays no stage: its state is the
    # stage-0 draw the chain makes from the init's k_env
    v2_start = make_chain_reset(CHAIN[:1], [], n_draw, CAP, dev)[0](
        TF.split(TF.key(SEED), 3)[0])[0]
    if not bool(compare_states(v2_start, draw, n_draw).all()):
        fail("the draw checked is not the chain's stage 0 on the init's key")

    stamp("m")
    # ---- m. the main path: the chain trainer, counted ----------------------
    # on ngx's keys: the init on key(SEED + 1), the refresh on key(SEED +
    # 2), step u on key(SEED + 3 + u)
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
    R.pool_reset.launches = 0
    resets_before = NR.native_reset.launches
    init_m, step_m = make_train_chain(cfg_c, CHAIN, stages, bc_data=bc_data,
                                      device=dev)
    carry_m = init_m(TF.key(SEED + 1))
    step_m.phases = {}
    carry_m = step_m.refresh_pool(carry_m, TF.key(SEED + 2))
    eps_m = []
    for u in range(3):
        carry_m, metrics_m = step_m(carry_m, TF.key(SEED + 3 + u))
        eps_m.append(int(metrics_m["episodes"]))
        for k in ("pg_loss", "v_loss", "entropy"):
            if not math.isfinite(float(metrics_m[k])):
                fail(f"chain train step {u}: {k} is not finite")
    torch.cuda.synchronize()
    launches_chain = TR.train_rollout.launches["pool"]
    draws_chain = NR.native_reset.launches - resets_before
    print(f"[m] make_train_chain({CHAIN[-1]}, B={B}, T={T}, solve_shaped, "
          f"bc_coef 0.05 on {bc_data[0].shape[0]} demo frames): init, one "
          f"refresh_pool, 3 train steps: train_rollout launches "
          f"{TR.train_rollout.launches}, stage-0 native_reset draws "
          f"{draws_chain}, rollout launches "
          f"{sum(R.rollout.launches.values())}, "
          f"episodes a step {eps_m}, last metrics "
          f"{ {k: float(v) for k, v in metrics_m.items()} }")
    for name, secs in step_m.phases.items():
        print(f"[m] {smi}: chain train step (B={B} T={T}, P "
              f"{pool_l.batch}, 3 stages x cap {CAP}) phase {name}: "
              f"{['%.6f' % (x * 1e3) for x in secs]} ms")
    if launches_chain != 3 or TR.train_rollout.launches["native"] or \
            draws_chain != 2 or sum(R.rollout.launches.values()) or \
            R.pool_reset.launches:
        fail("the chain trainer did not launch the pool-mode kernel exactly "
             "3 times and draw stage 0 exactly twice (by the native reset, "
             "no rollout kernel)")
    # the init's base is each env's step_count, so no env meets the cap
    # (100 > T) in the first step: episodes are counted over the 3 steps
    if sum(eps_m) < B or min(eps_m) < 1:
        fail(f"episodes a chain train step {eps_m}: expected at least one "
             f"each and {B} over the three")
    if not torch.isfinite(carry_m[2]).all() or carry_m[2].shape != (
            B, obs_dim_of(v5)):
        fail("the chain carry's obs is not finite or has the wrong shape")

    stamp("n")
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

    stamp("o")
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

    stamp("p")
    # ---- p. the env-stepping ablations, variants of the 'prng' kernel -----
    from ngx_torch.core.state import make_state_packers

    ablations = (("hash", dict(action_rng="hash")),
                 ("fixed", dict(action_rng="fixed")),
                 ("no-reset", dict(auto_reset=False)),
                 ("packed", dict(packed=True)))
    abl_err, abl_plain = {}, {}
    for env_id, novs in ((POGO, ()), ("NovelGridworld-v3", ()),
                         (POGO, firewall)):
        sp = novelty_spec(env_id, novs)
        plain_k = R.rollout(sp, B, T, SEED, ROLLOUT_BLOCK, "prng", device=dev)
        for name, kw in ablations:
            out_k = R.rollout(sp, B, T, SEED, ROLLOUT_BLOCK, "prng",
                              device=dev, **kw)
            torch.cuda.synchronize()
            out_p, p_ms = sync_ms(lambda: R.rollout_plain(
                sp, B, T, SEED, ROLLOUT_BLOCK, "prng", device=dev, **kw))
            same = compare_states(out_k[0], out_p[0]) \
                & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
            abl_err[name] = max(abl_err.get(name, 0.0), float(
                (out_k[1] - out_p[1]).abs().max()))
            if env_id == POGO and not novs:
                abl_plain[name] = p_ms
            n_done = int(out_k[2].sum())
            print(f"[p] prng:{name:8s} {env_id} {sp.novelty_tag} B={B} "
                  f"T={T}: {n_done} episode ends, {int((~same).sum())} envs "
                  f"differ from the twin; twin {p_ms:.4f} ms")
            if not bool(same.all()):
                fail(f"prng:{name} kernel and twin disagree on {env_id} "
                     f"{sp.novelty_tag}")
            if env_id == "NovelGridworld-v3" and name != "fixed" \
                    and n_done == 0:
                fail(f"prng:{name}: no episode end on v3")
            if name == "packed":
                same_p = compare_states(out_k[0], plain_k[0]) \
                    & (out_k[1] == plain_k[1]) & (out_k[2] == plain_k[2])
                if not bool(same_p.all()):
                    fail(f"packed differs from the unpacked kernel on "
                         f"{env_id} {sp.novelty_tag}")
    print(f"[p] packed: {make_state_packers(pogo)[2]} words an env on "
          f"Pogostick-v1, equal to the unpacked kernel's state bit for bit "
          f"on the three specs")
    # ptxas and SASS of every variant of the rollout kernel (V: 0 'prng',
    # 1 'input', 2 hash, 3 fixed, 4 no reset, 5 packed)
    counts = _build.sass_counts(path)
    for name, (mangled, (n_sass, n_bssy)) in zip(_build.demangle(counts),
                                                 counts.items()):
        if "14rollout_kernel" in mangled:
            print(f"[p] {name}: {n_sass} SASS instructions, {n_bssy} BSSY; "
                  f"ptxas {'; '.join(ptxas.get(mangled, ['(not built here)']))}")
    if not any("14rollout_kernel" in m for m in counts):
        fail("cuobjdump listed no rollout_kernel")
    # the main paths: throughput_fn with each ablation, counted
    abl_launch = {}
    for name, kw in ablations:
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        st_a, mean_a = throughput_fn(pogo, B, T, device=dev, **kw)(SEED)
        torch.cuda.synchronize()
        abl_launch[name] = R.rollout.launches[f"prng:{name}"]
        others = sum(R.rollout.launches.values()) - abl_launch[name]
        print(f"[p] main path: throughput_fn(..., {kw}) launched "
              f"rollout:prng:{name} {abl_launch[name]}x, other variants "
              f"{others}x (mean reward {float(mean_a)})")
        if abl_launch[name] < 1 or others:
            fail(f"throughput_fn({kw}) did not launch its variant alone")
        if not math.isfinite(float(mean_a)) or st_a.map.shape != (
                B, pogo.map_size ** 2):
            fail(f"throughput_fn({kw}) gave a bad state or mean")
    abl_dev = {name: device_ms(lambda: R.rollout(
        pogo, B, T, SEED, ROLLOUT_BLOCK, "prng", device=dev, **kw))
        for name, kw in ablations}
    # ngx's breakdown on the card: the five variants' device time at T 1024,
    # one pass in order (a reversed second pass would repeat the timing)
    variants = (("full", {}),) + ablations
    for b_rate in RATE_BATCHES:
        times = {}
        for name, kw in variants:
            run = throughput_fn(pogo, b_rate, RATE_T, device=dev, **kw)
            times[name] = device_ms(lambda: run(SEED))
        print(f"[p] {smi}: ablations, Pogostick-v1 B={b_rate} T={RATE_T}, "
              "kernel device ms: "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()))
    # the events fallback of the device time against the profiler, on the
    # full variant at the first batch
    run = throughput_fn(pogo, RATE_BATCHES[0], RATE_T, device=dev)
    prof_ms, prof_n, source = kernel_device_ms(lambda: run(SEED), REPS)
    ev_ms, ev_n = launch_event_ms(lambda: run(SEED), REPS)
    print(f"[p] {smi}: full B={RATE_BATCHES[0]} T={RATE_T} device ms by "
          f"{source} {prof_ms} ({prof_n} launches), by events around each "
          f"launch {ev_ms} ({ev_n} launches)")
    if ev_n != REPS:
        fail(f"events timed {ev_n} of {REPS} launches")
    if source == "profiler" and not 0.9 <= ev_ms / prof_ms <= 1.5:
        fail(f"events' device time {ev_ms} ms against the profiler's "
             f"{prof_ms} ms")

    stamp("q")
    # ---- q. the unfused acting backend ('xla') against the kernel --------
    from ngx_torch.rl.train import rollout_unfused
    from ngx_torch.vector import VecEnv

    model_q = ActorCritic.from_key(TF.key(SEED), obs_dim, spec.n_actions,
                                   HIDDEN).to(dev)
    if not all(torch.equal(a, w) for (a, _), (w, _) in zip(
            layers, model_q.pi_layers())):
        fail("phase q's model is not phase 3's policy")
    vec_q = VecEnv(spec, episode_cap=CAP, reset_obs=True)
    obs_q = nt.make_step(spec).get_obs(state).to(torch.float32)
    # the unfused loop under the kernel's own noise: the counter RNG's
    # Gumbel of each step (salt 5, ctr t + 1, the streams of SEED in blocks
    # of ``block``), and VecEnv's counter resets, the kernel's semantics
    seeds_q, rows_q = block_streams(SEED, B, block, dev)
    zeros_q = torch.zeros((B, spec.n_actions), device=dev)
    noise_q = torch.stack([TR.gumbel_scores(zeros_q, seeds_q, t + 1, rows_q)
                           for t in range(T)])
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
    out_x, x_ms = sync_ms(lambda: rollout_unfused(
        model_q, lambda st, a, t: vec_q.step(st, a, SEED, t + 1, block)[:4],
        state, obs_q, noise_q))
    if sum(TR.train_rollout.launches.values()) or \
            sum(R.rollout.launches.values()):
        fail("the unfused acting loop launched a kernel")
    out_k = TR.train_rollout(spec, state, layers, SEED, T, block=block,
                             cap=CAP)
    check_agreement("[q]", spec, out_k, out_x[:5], layers, block, CAP,
                    "native resets", "the xla loop")
    print(f"[q] {smi}: acting on Pogostick-v1 B={B} T={T}: the xla loop "
          f"{x_ms:.4f} ms (host clock), the kernel {kernel_ms:.4f} ms "
          "(phase 5)")

    def run_backend(tag, backend, spec_q):
        """3 make_train steps through ``backend``, counted and by phase."""
        init_q, step_q = make_train(PPOConfig(num_envs=B),
                                    spec_override=spec_q,
                                    rollout_backend=backend, device=dev)
        carry_q = init_q(SEED)
        torch.cuda.synchronize()
        TR.train_rollout.launches.update(native=0, pool=0)
        R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
        R.pool_reset.launches = 0
        step_q.phases = {}
        eps_q = 0
        for u in range(3):
            carry_q, m_q = step_q(carry_q, SEED + u + 1)
            eps_q += int(m_q["episodes"])
            for k in ("pg_loss", "v_loss", "entropy"):
                if not math.isfinite(float(m_q[k])):
                    fail(f"{tag} {backend} train step {u}: {k} not finite")
        torch.cuda.synchronize()
        counts_q = (dict(TR.train_rollout.launches),
                    sum(R.rollout.launches.values()), R.pool_reset.launches)
        print(f"[q] 3 train steps on {tag}, rollout_backend {backend!r} "
              f"(taken: {step_q.rollout_backend}, resets {step_q.reset_source})"
              f": train_rollout launches {counts_q[0]}, rollout launches "
              f"{counts_q[1]}, pools {counts_q[2]}, {eps_q} episodes")
        for name, secs in step_q.phases.items():
            print(f"[q] {smi}: {tag} train step [{backend}] phase {name}: "
                  f"{['%.6f' % (x * 1e3) for x in secs]} ms")
        if not torch.isfinite(carry_q[2]).all() or eps_q <= 0:
            fail(f"{tag} {backend}: a bad obs or no episode")
        return counts_q

    for tag, spec_q in (("Pogostick-v1", None), ("fence medium", fence_m)):
        counts_x = run_backend(tag, "xla", spec_q)
        if sum(counts_x[0].values()) or counts_x[1] or counts_x[2]:
            fail(f"make_train(rollout_backend='xla') on {tag} launched a "
                 "kernel or drew a pool")
    run_backend("Pogostick-v1", "pallas", None)
    for name, secs in step_f.phases.items():
        print(f"[q] {smi}: fence medium train step [pallas] phase {name}: "
              f"{['%.6f' % (x * 1e3) for x in secs]} ms (phase g)")
    init_qc, step_qc = make_train_chain(cfg_c, CHAIN, stages, bc_data=bc_data,
                                        rollout_backend="xla", device=dev)
    carry_qc = init_qc(SEED + 1)
    torch.cuda.synchronize()
    TR.train_rollout.launches.update(native=0, pool=0)
    R.rollout.launches.update(dict.fromkeys(R.rollout.launches, 0))
    R.pool_reset.launches = 0
    step_qc.phases = {}
    carry_qc, m_qc = step_qc(carry_qc, SEED + 3)
    torch.cuda.synchronize()
    print(f"[q] make_train_chain({CHAIN[-1]}, rollout_backend 'xla'): one "
          f"train step, train_rollout launches {TR.train_rollout.launches}, "
          f"rollout launches {sum(R.rollout.launches.values())}, metrics "
          f"{ {k: float(v) for k, v in m_qc.items()} }")
    for name, secs in step_qc.phases.items():
        print(f"[q] {smi}: chain train step [xla] phase {name}: "
              f"{['%.6f' % (x * 1e3) for x in secs]} ms; [pallas] (phase m) "
              f"{['%.6f' % (x * 1e3) for x in step_m.phases.get(name, [])]}")
    if sum(TR.train_rollout.launches.values()) or \
            sum(R.rollout.launches.values()):
        fail("the chain's xla train step launched a kernel")
    for k in ("pg_loss", "v_loss", "entropy"):
        if not math.isfinite(float(m_qc[k])):
            fail(f"chain xla train step: {k} is not finite")
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "ngx_torch.cli.train", "-env", POGO,
                "-num_envs", str(B), "-steps", str(B * T),
                "-rollout_backend", "xla", "-log", os.path.join(tmp, "log")]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                              timeout=600)
        secs = time.perf_counter() - t0
        print(f"[q] {' '.join(argv[1:])}: rc {proc.returncode}, "
              f"{secs:.3f} s; {proc.stdout.strip().splitlines()[-1:]}")
        if proc.returncode != 0:
            fail(f"the training CLI with -rollout_backend xla failed:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(tmp, "log", "progress.monitor.csv")) as f:
            if len(f.read().splitlines()) != 3:
                fail("the xla CLI run did not log exactly one update")

    stamp("r")
    # ---- r. the multi-device layer: the sharded trainer --------------------
    r_paths, w1_step, w2, r_err = _phase_r(dev, smi)

    stamp("s")
    # ---- s. the single-env facade and its drivers -------------------------
    _phase_s(dev, smi)

    stamp("t")
    # ---- t. NGX_DEBUG, the recorder, the Monitor, the last drivers --------
    _phase_t(dev, smi)

    stamp("u")
    # ---- u. the drop-in surface and the plain path past the kernels --------
    helpers = types.SimpleNamespace(
        sync_ms=sync_ms, event_ms=event_ms, device_ms=device_ms,
        compare_states=compare_states, check_train_kernel=check_train_kernel,
        check_agreement=check_agreement, bound=bound, obs_dim_of=obs_dim_of,
        policy_layers=policy_layers, block=block)
    _phase_u(dev, smi, helpers)

    stamp("v")
    # ---- v. the kernels past 64 and 128 item ids, and NOOP ----------------
    v_launch, v_paths, v_rows, v_int8 = _phase_v(dev, smi, helpers)

    stamp("w")
    # ---- w. the tile kernels' reset phase on reset-heavy tiles -----------
    _phase_w(dev, smi, helpers)

    stamp("x")
    # ---- x. ngx's own seeded draws: threefry, make_reset, the scan ---------
    _phase_x(dev, smi, helpers)

    stamp("y")
    # ---- y. the PPO main path on ngx's keys ---------------------------------
    y_paths = _phase_y(dev, smi, helpers)

    stamp("z")
    # ---- z. the chain, the CLI and the mesh's stepping on ngx's keys ---------
    z_paths, z_err = _phase_z(dev, smi, helpers)

    stamp("kp")
    # ---- kp. the perf CLI's trainer and policy modes on ngx's keys ---------
    kp_paths, kp_err = _phase_kp(dev, smi, helpers)
    stamp("the kernels line")

    dims = [obs_dim, *HIDDEN, spec.n_actions]
    dims_f = [pool_layers[0][0].shape[1], *HIDDEN, fence_m.n_actions]
    dims_c = [solver_layers[0][0].shape[1], *HIDDEN, v5.n_actions]
    records = [
        ("train_rollout:native", "train_rollout.cu", ":812", launches,
         {"make_train(Pogostick-v1)": launches},
         max(max_abs_err, r_err["native"]), kernel_ms,
         plain_ms, bound(spec, dims, B, T, "train")),
        ("train_rollout:pool", "train_rollout.cu", ":812", launches_pool,
         {"make_train(fence medium)": launches_pool},
         max(pool_err, r_err["fence"]), pool_ms,
         pool_plain_ms, bound(fence_m, dims_f, B, T, "train", n_pool)),
        ("train_rollout:pool:chain", "train_rollout.cu", ":812",
         launches_chain, {"make_train_chain(v2..v5)": launches_chain},
         max(chain_err, z_err), chain_ms, chain_plain_ms,
         bound(v5, dims_c, B, T, "train", B * POOL_R)),
        ("rollout:prng", "rollout.cu", ":533", prng_g,
         {"make_train(fence medium) pools": prng_g,
          "throughput_fn": launches_prng}, err["prng"], rate["prng"],
         plain_t["prng"], bound(pogo, [], B, T, "prng")),
        ("rollout:input", "rollout.cu", ":533", launches_input,
         {"make_rollout('input')": launches_input}, err["input"],
         rate["input"], plain_t["input"], bound(pogo, [], B, T, "input")),
        ("rollout:policy", "rollout.cu", ":533", launches_policy,
         {"make_rollout('policy')": launches_policy}, err_policy,
         rate["policy"], plain_t["policy"],
         bound(spec, dims, B, POLICY_RATE_T, "policy")),
    ] + [
        (f"rollout:prng:{name}", "rollout.cu", ":533", abl_launch[name],
         {f"throughput_fn({kw})": abl_launch[name]}, abl_err[name],
         abl_dev[name], abl_plain[name],
         bound(pogo, [], B, T, "prng",
               words=make_state_packers(pogo)[2] if kw.get("packed") else 0))
        for name, kw in ablations] + [
        (row, "rollout.cu" if row.startswith("rollout") else
         "train_rollout.cu", ":533" if row.startswith("rollout") else ":812",
         v_launch[row], {v_paths[row]: v_launch[row]}, *v_rows[row])
        for row in v_launch]
    # phase r's sharded main paths, per rank
    sharded = {"train_rollout:native": {}, "train_rollout:pool": {},
               "rollout:prng": {}, "rollout:prng:packed": {}}
    for who in ("W1", "W2 rank 0", "W2 rank 1"):
        at = (f"mesh {who}, nccl" if who == "W1" else
              f"mesh {who}, gloo on one card")
        sharded["train_rollout:native"][f"make_train({at})"] = \
            r_paths["native", who]["native"]
        sharded["train_rollout:pool"][f"make_train(fence medium, {at})"] = \
            r_paths["fence", who]["pool"]
        res = w1_step if who == "W1" else w2[int(who[-1])]["stepping"]
        sharded["rollout:prng"].update({
            f"make_train(fence medium, {at}) pools":
                r_paths["fence", who]["pools"],
            f"sharded_throughput_fn + make_spmd_rollout({at})":
                res["launches"]["prng"]})
        sharded["rollout:prng:packed"][f"make_spmd_rollout(packed, {at})"] = \
            res["launches"]["prng:packed"]
    records = [(name, src, line, n, {**paths, **sharded.get(name, {}),
                                     **v_int8.get(name, {}),
                                     **y_paths.get(name, {}),
                                     **z_paths.get(name, {}),
                                     **kp_paths.get(name, {})},
                max(e, kp_err.get(name, 0.0)), ms, p_ms, b)
               for name, src, line, n, paths, e, ms, p_ms, b in records]
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
