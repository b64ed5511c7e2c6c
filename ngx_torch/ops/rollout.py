"""The env-stepping rollout: a CUDA kernel and its plain twin.

Port of ``make_pallas_rollout`` (``ngx/ops/pallas_rollout.py:533``, kernel
``:710``, call ``:776``).  For each env: the counter-RNG reset at ``ctr =
0`` of its RNG block, then T steps with no episode cap, whose actions come
from one of three sources —

* ``'prng'``: ``_randint(seed, t+1, salt 1, row, col 0) % A`` (``:655``),
  the env-stepping benchmark (:func:`ngx_torch.vector.throughput_fn`);
* ``'input'``: an ``int32[T, B]`` stream (``:638-642``, ``:760-761``), the
  bit-exact parity harness;
* ``'policy'``: LidarInFront obs -> tanh MLP -> Gumbel-argmax with salt 5
  (``:568-594``, ``:643-653``).  The JAX kernel bakes the weights in as
  constants; here they are a run-time argument, ``pi_layers``, as for
  :func:`ngx_torch.ops.train_rollout.train_rollout`.  This mode's plain twin
  takes the place of ``make_xla_policy_rollout`` (``:1234``) as the unfused
  comparator.

'prng' also runs the ablations of ngx's ``throughput_fn``
(``ngx/vector/__init__.py:119-204``), one at a time as ngx's perf breakdown
runs them (``ngx/cli/perf.py:127-135``), each a variant of the kernel
(:data:`VARIANTS`): ``action_rng='hash'`` (ngx's ``_hash_actions``,
:func:`ngx_torch.ops.rng.hash_actions`) or ``'fixed'`` (action 0) in place
of the counter draw, ``auto_reset=False`` (done envs step on from their
terminal state; the done counts still add up) and ``packed=True`` (the
kernel writes the final state in
:func:`~ngx_torch.core.state.make_state_packers`' words, which the wrapper
unpacks; the kernel keeps the state on chip between steps, so this is
ngx's packed carry's counterpart).

Each step is followed, where the env is done, by the counter-RNG reset at
``ctr = t+1``.  The result is the final state and, per env, the float32 sum
of the rewards and the count of episode ends.

:func:`make_rollout` builds ``run(seed, actions=None) -> (state,
mean_reward, n_done)`` as ``pallas_rollout.py:780-801`` does; :func:`rollout`
is the wrapper under it: on a CUDA device it launches ``csrc/rollout.cu``
(built by :mod:`ngx_torch.ops._build`) or raises, on the CPU it runs
:func:`rollout_plain`.

Parity hazards (each also named where it is handled):

* The initial state is drawn in the kernel at ``ctr = 0`` for each logical
  block (``:633-636``, ``:718``); a boundary at step ``t`` resets with
  ``ctr = t+1``.  There is no episode cap in any mode.
* A fresh state carries the reward sum and the done count over (``:668``).
* The reward sum of each env is a running float32 sum, ``fregs[:, 2] + r``
  added step by step (``:664``): the twin adds step by step too, never
  ``torch.sum`` over T, because the order of the adds changes the float32
  result.  Only the batch mean may differ from JAX's (rtol 1e-6), because
  the batch is summed in another order.
* ``steps = 0`` returns the ctr-0 reset (``tests/test_pallas.py:45``); the
  mean is then 0 (the denominator is ``max(B*T, 1)``).
* The RNG block defaults to 512, as the JAX kernel's, and is logical: it
  does not depend on the CUDA launch geometry.
* ``'policy'``: the MLP sums in another order than torch's matmul, so an
  action can differ from the twin's only at a near-tie of the Gumbel score;
  the CUDA kernel shares its MLP, Gumbel and step device code with the
  train-rollout kernel (``csrc/ngx_env.cuh``), so the two kernels agree bit
  for bit from the same start.
"""

from __future__ import annotations

import torch

from ..core import spec as S
from ..core.reset import ResetTables, reset_rows
from ..core.state import make_state_packers
from ..core.step import make_step
from .rng import _randint, block_streams, hash_actions
from .tables import (c_ints, check_tensor, device_tables, has_novelty,
                     host_header, policy_params, resolve_device, seed_i32,
                     unpack_state)
from .train_rollout import gumbel_argmax, mlp_logits

SOURCES = ("prng", "input", "policy")
SALT_PRNG_ACTION = 1
# 'prng''s action draws: the counter RNG (the default; the port's stand-in
# for ngx's threefry, which torch cannot reproduce), ngx's hash, action 0
ACTION_RNGS = ("counter", "hash", "fixed")
# the kernel's variants (csrc/rollout.cu WarpVariant, in its order), the
# keys of rollout.launches
VARIANTS = ("prng", "input", "prng:hash", "prng:fixed", "prng:no-reset",
            "prng:packed", "policy")
# CUDA threads per thread block by action source, and the envs of a block
# in 'policy' mode (the tile MLP of csrc/ngx_env.cuh); they change no result
# (the RNG block is logical).  PERF.md has the sweeps: 'prng' (4 warps of
# 32 envs) at 128 ties 64 and beats 256 by 4% at B 8,192, T 1,024, and
# trails 256 by 2% at B 262,144; 'policy' at 32 envs x 256 threads was the
# fastest of E 16/32/64 x N 16-256 at B 8,192, T 256.
POLICY_ENVS = 32
THREADS = {"prng": 128, "input": 128, "policy": 256}
# 'prng' and 'input': a warp steps 32 envs and resets the k envs a step
# finished together, in groups of max(32 / next_pow2(k), RESET_LANES) lanes
# an env (csrc/ngx_env.cuh warp_reset); a power of 2 up to 32, which
# changes no result.  1 (the one-lane loop when all 32 reset) beat 2 and 4
# on the pool draw by 6% and 24% (PERF.md).
RESET_LANES = 1


def variant(action_source, action_rng="counter", auto_reset=True,
            packed=False) -> str:
    """The name of the kernel variant that runs these arguments (a key of
    :data:`VARIANTS`); raises for a combination the kernel does not
    instantiate: an ablation outside 'prng', or two at once."""
    if action_source not in SOURCES:
        raise ValueError(f"action_source {action_source!r} is not one of "
                         f"{SOURCES}")
    if action_rng not in ACTION_RNGS:
        raise ValueError(f"action_rng {action_rng!r} is not one of "
                         f"{ACTION_RNGS}")
    ablations = [n for n, on in (
        (action_rng, action_rng != "counter"),
        ("no-reset", not auto_reset), ("packed", packed)) if on]
    if not ablations:
        return action_source
    if action_source != "prng" or len(ablations) > 1:
        raise ValueError(
            f"{action_source!r} with {' and '.join(ablations)}: the rollout "
            "kernel runs the ablations in 'prng' mode, one at a time, as "
            "ngx's perf breakdown does (ngx/cli/perf.py:127-135)")
    return f"prng:{ablations[0]}"


def _check_args(spec, batch, steps, block, action_source, pi_layers,
                action_rng="counter", auto_reset=True, packed=False):
    S.check_supported(spec)
    variant(action_source, action_rng, auto_reset, packed)
    if batch < 1 or steps < 0 or block < 1 or batch % block:
        raise ValueError(f"batch {batch} must be a positive multiple of the "
                         f"RNG block {block}; steps {steps} must be >= 0")
    if action_source == "policy":
        if spec.obs_mode != S.OBS_LIDAR_FRONT:
            raise ValueError("the policy rollout needs a lidar_in_front spec")
        if not pi_layers:
            raise ValueError("'policy' mode takes pi_layers")


@torch.no_grad()
def rollout_plain(spec, batch: int, steps: int, seed: int, block: int = 512,
                  action_source: str = "prng", actions=None, pi_layers=None,
                  device=None, action_rng: str = "counter",
                  auto_reset: bool = True, packed: bool = False):
    """The plain twin of the kernel: the arguments and results of
    :func:`rollout`, on ``device``."""
    _check_args(spec, batch, steps, block, action_source, pi_layers,
                action_rng, auto_reset, packed)
    seeds, rows = block_streams(seed, batch, block, device)
    tab = ResetTables(spec)
    step = make_step(spec, with_obs=False)
    state = reset_rows(tab, seeds, 0, rows)          # the ctr-0 reset
    col0 = torch.zeros((1,), dtype=torch.int64, device=device)
    rsum = torch.zeros((batch,), dtype=torch.float32, device=device)
    dcount = torch.zeros((batch,), dtype=torch.int32, device=device)
    for t in range(steps):
        ctr = t + 1
        if action_source == "input":
            a = actions[t]
        elif action_rng == "hash":
            a = hash_actions(batch, t, spec.n_actions, device)
        elif action_rng == "fixed":
            a = torch.zeros((batch,), dtype=torch.int64, device=device)
        elif action_source == "prng":
            a = _randint(seeds, ctr, SALT_PRNG_ACTION, rows, col0,
                         spec.n_actions)[:, 0]
        else:
            obs = step.get_obs(state).to(torch.float32)
            a = gumbel_argmax(mlp_logits(obs, pi_layers), seeds, ctr, rows)
        state, _, r, done, _ = step(state, a)
        rsum = rsum + r                  # step by step, as the kernel adds
        dcount = dcount + done.to(torch.int32)
        idx = done.nonzero()[:, 0] if auto_reset else ()
        if len(idx):
            state = state.put(idx, reset_rows(tab, seeds[idx], ctr, rows[idx]))
    if packed:                          # the kernel packs the final state
        pack, unpack, _ = make_state_packers(spec)
        state = unpack(pack(state))
    return state, rsum, dcount


@torch.no_grad()
def rollout(spec, batch: int, steps: int, seed: int, block: int = 512,
            action_source: str = "prng", actions=None, pi_layers=None,
            device="cuda", threads=None, action_rng: str = "counter",
            auto_reset: bool = True, packed: bool = False):
    """Run ``steps`` steps of ``batch`` envs, each from its ctr-0 reset.

    ``actions``: ``int32[steps, batch]`` on ``device`` ('input' mode);
    ``pi_layers``: the policy tower ``[(weight[out, in], bias[out]), ...]``
    on ``device`` ('policy' mode, a LidarInFront spec).  Returns ``(state,
    reward_sum[B] f32, done_count[B] i32)``.  A CPU device runs the plain
    twin; a CUDA device launches the kernel on the current stream (and bumps
    ``rollout.launches`` under the kernel's variant, :func:`variant`) or
    raises.  ``threads``: CUDA threads per thread block (default
    :data:`THREADS`), which changes no result.  ``action_rng``,
    ``auto_reset``, ``packed``: the 'prng' ablations (module docstring).
    ``device`` defaults to the card and raises where there is none."""
    device = resolve_device(device)
    _check_args(spec, batch, steps, block, action_source, pi_layers,
                action_rng, auto_reset, packed)
    if action_source == "input":
        check_tensor(actions, "actions", torch.int32, (steps, batch), device)
    ablate = dict(action_rng=action_rng, auto_reset=auto_reset, packed=packed)
    if device.type == "cpu":
        return rollout_plain(spec, batch, steps, seed, block, action_source,
                             actions, pi_layers, device, **ablate)
    if device.type != "cuda":
        raise ValueError(f"no rollout for device {device}")
    from ._build import load_library
    out = launch(load_library(), spec, batch, steps, seed, block,
                 action_source, actions, pi_layers, device,
                 torch.cuda.current_stream(device).cuda_stream, threads,
                 **ablate)
    rollout.launches[variant(action_source, **ablate)] += 1
    return out


rollout.launches = dict.fromkeys(VARIANTS, 0)


def launch(lib, spec, batch, steps, seed, block, action_source, actions,
           pi_layers, device, stream, threads=None, action_rng="counter",
           auto_reset=True, packed=False):
    """Check every tensor, allocate the outputs and call the library's
    ``ngx_rollout`` once (see :func:`rollout`)."""
    B, T = int(batch), int(steps)
    H, I, A = spec.map_size, spec.n_items, spec.n_actions
    HW = H * H
    i32 = torch.int32
    dims, params, act = (), None, None
    if action_source == "policy":
        dims, params = policy_params(spec, pi_layers, device)
    if action_source == "input":
        act = actions
        check_tensor(act, "actions", i32, (T, B), device)
        # an action indexes the kernel's tables
        if T and not bool(((act >= 0) & (act < A)).all()):
            raise ValueError(f"actions must lie in [0, {A})")
    tab = device_tables(spec, dims, device)
    sums = (torch.empty((B,), dtype=torch.float32, device=device),
            torch.empty((B,), dtype=i32, device=device))
    if packed:
        _, unpack, n_words = make_state_packers(spec)
        words = torch.empty((B, n_words), dtype=i32, device=device)
        outs = (None,) * 4 + sums + (words,)
    else:
        outs = (torch.empty((B, HW), dtype=i32, device=device),
                torch.empty((B, 7), dtype=i32, device=device),
                torch.empty((B, 2), dtype=torch.float32, device=device),
                torch.empty((B, I), dtype=i32, device=device)) + sums + (None,)
    timed = launch.events is not None
    if timed:
        # a spin ahead of the start event keeps the stream busy through the
        # host's call, so the pair brackets the kernel alone
        cur = torch.cuda.current_stream(device)
        torch.cuda._sleep(TIMING_SPIN_CYCLES)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(cur)
    rc = lib.ngx_rollout(
        tab.data_ptr(), tab.numel(), host_header(spec, dims),
        c_ints(dims) if dims else None,
        len(dims), act.data_ptr() if act is not None else None,
        params.data_ptr() if params is not None else None,
        params.numel() if params is not None else 0,
        SOURCES.index(action_source), ACTION_RNGS.index(action_rng),
        int(bool(auto_reset)), seed_i32(seed), B, T, int(block),
        POLICY_ENVS, int(threads or THREADS[action_source]), RESET_LANES, HW,
        I, *[o.data_ptr() if o is not None else None for o in outs],
        int(has_novelty(spec)), stream)
    if rc != 0:
        raise RuntimeError("rollout kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    if timed:
        ev[1].record(cur)
        launch.events.append(ev)
    state = unpack(words) if packed else unpack_state(*outs[:4])
    return state, outs[4], outs[5]


# a list to time each launch's kernel by a pair of CUDA events recorded
# around it on its stream (``cli/perf.py`` kernel_device_ms); None, the
# default, records nothing
launch.events = None
# cycles of the spin ahead of a timed launch (about 0.5 ms on an H100)
TIMING_SPIN_CYCLES = 1_000_000


def pool_reset(spec, n: int, seed: int, device="cuda"):
    """``n`` fresh states, rows ``0..n-1`` of the ctr-0 counter reset under
    ``seed`` — the port of ``make_xla_pool_reset(spec, n)(seed)``
    (``pallas_rollout.py:450``), the trainer's reset pool.  It is
    :func:`rollout` at ``steps = 0`` in one RNG block of ``n`` envs: on the
    card the rollout kernel (counted in ``pool_reset.launches`` too), so the
    pool needs no plain code there; on the CPU its twin."""
    state, _, _ = rollout(spec, n, 0, seed, block=n, action_source="prng",
                          device=device)
    if state.device.type == "cuda":
        pool_reset.launches += 1
    return state


pool_reset.launches = 0


def make_rollout(spec, batch: int, steps: int, block: int = 512,
                 action_source: str = "prng", pi_layers=None, device="cuda",
                 threads=None, action_rng: str = "counter",
                 auto_reset: bool = True, packed: bool = False):
    """``run(seed, actions=None) -> (EnvState[batch], mean_reward, n_done)``
    — the port of ``make_pallas_rollout``'s ``run`` (``:780-801``): the mean
    of the per-env reward sums over ``max(batch * steps, 1)``, float32, and
    the total count of episode ends.  ``pi_layers`` ('policy' mode),
    ``actions`` ('input' mode) and the 'prng' ablations as for
    :func:`rollout`."""
    ablate = dict(action_rng=action_rng, auto_reset=auto_reset, packed=packed)
    _check_args(spec, batch, steps, block, action_source, pi_layers, **ablate)

    def run(seed: int, actions=None):
        state, rsum, dcount = rollout(spec, batch, steps, seed, block,
                                      action_source, actions, pi_layers,
                                      device, threads, **ablate)
        return state, rsum.sum() / max(batch * steps, 1), dcount.sum()

    return run
