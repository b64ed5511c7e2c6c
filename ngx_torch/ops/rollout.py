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
from ..core.step import make_step
from .rng import _randint, block_streams
from .tables import (check_tensor, device_tables, has_novelty, policy_params,
                     resolve_device, seed_i32, unpack_state)
from .train_rollout import gumbel_argmax, mlp_logits

SOURCES = ("prng", "input", "policy")
SALT_PRNG_ACTION = 1
# CUDA threads per thread block by action source; they change no result
# (the RNG block is logical).  PERF.md has the sweep over 32/64/128/256:
# 'prng' at 128 matches 32 at B 8,192 and beats it by 9-31% from B 131,072
# on; 'policy' is fastest at 32.
THREADS = {"prng": 128, "input": 128, "policy": 32}


def _check_args(spec, batch, steps, block, action_source, pi_layers):
    S.check_supported(spec)
    if action_source not in SOURCES:
        raise ValueError(f"action_source {action_source!r} is not one of "
                         f"{SOURCES}")
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
                  device=None):
    """The plain twin of the kernel: the arguments and results of
    :func:`rollout`, on ``device``."""
    _check_args(spec, batch, steps, block, action_source, pi_layers)
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
        elif action_source == "prng":
            a = _randint(seeds, ctr, SALT_PRNG_ACTION, rows, col0,
                         spec.n_actions)[:, 0]
        else:
            obs = step.get_obs(state).to(torch.float32)
            a = gumbel_argmax(mlp_logits(obs, pi_layers), seeds, ctr, rows)
        state, _, r, done, _ = step(state, a)
        rsum = rsum + r                  # step by step, as the kernel adds
        dcount = dcount + done.to(torch.int32)
        idx = done.nonzero()[:, 0]
        if idx.numel():
            state = state.put(idx, reset_rows(tab, seeds[idx], ctr, rows[idx]))
    return state, rsum, dcount


@torch.no_grad()
def rollout(spec, batch: int, steps: int, seed: int, block: int = 512,
            action_source: str = "prng", actions=None, pi_layers=None,
            device="cuda", threads=None):
    """Run ``steps`` steps of ``batch`` envs, each from its ctr-0 reset.

    ``actions``: ``int32[steps, batch]`` on ``device`` ('input' mode);
    ``pi_layers``: the policy tower ``[(weight[out, in], bias[out]), ...]``
    on ``device`` ('policy' mode, a LidarInFront spec).  Returns ``(state,
    reward_sum[B] f32, done_count[B] i32)``.  A CPU device runs the plain
    twin; a CUDA device launches the kernel on the current stream (and bumps
    ``rollout.launches[action_source]``) or raises.  ``threads``: CUDA
    threads per thread block (default :data:`THREADS`), which changes no
    result.  ``device`` defaults to the card and raises where there is
    none."""
    device = resolve_device(device)
    _check_args(spec, batch, steps, block, action_source, pi_layers)
    if action_source == "input":
        check_tensor(actions, "actions", torch.int32, (steps, batch), device)
    if device.type == "cpu":
        return rollout_plain(spec, batch, steps, seed, block, action_source,
                             actions, pi_layers, device)
    if device.type != "cuda":
        raise ValueError(f"no rollout for device {device}")
    from ._build import load_library
    out = launch(load_library(), spec, batch, steps, seed, block,
                 action_source, actions, pi_layers, device,
                 torch.cuda.current_stream(device).cuda_stream, threads)
    rollout.launches[action_source] += 1
    return out


rollout.launches = dict.fromkeys(SOURCES, 0)


def launch(lib, spec, batch, steps, seed, block, action_source, actions,
           pi_layers, device, stream, threads=None):
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
    maxw = max(dims) if dims else 0
    scratch = torch.empty((2 * maxw * B,), dtype=torch.float32, device=device)
    outs = (torch.empty((B, HW), dtype=i32, device=device),
            torch.empty((B, 7), dtype=i32, device=device),
            torch.empty((B, 2), dtype=torch.float32, device=device),
            torch.empty((B, I), dtype=i32, device=device),
            torch.empty((B,), dtype=torch.float32, device=device),
            torch.empty((B,), dtype=i32, device=device))
    rc = lib.ngx_rollout(
        tab.data_ptr(), tab.numel(),
        act.data_ptr() if act is not None else None,
        params.data_ptr() if params is not None else None,
        params.numel() if params is not None else 0,
        SOURCES.index(action_source), seed_i32(seed), B, T, int(block),
        int(threads or THREADS[action_source]), HW, I, scratch.data_ptr(),
        maxw, *[o.data_ptr() for o in outs], int(has_novelty(spec)), stream)
    if rc != 0:
        raise RuntimeError("rollout kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    return unpack_state(*outs[:4]), outs[4], outs[5]


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
                 threads=None):
    """``run(seed, actions=None) -> (EnvState[batch], mean_reward, n_done)``
    — the port of ``make_pallas_rollout``'s ``run`` (``:780-801``): the mean
    of the per-env reward sums over ``max(batch * steps, 1)``, float32, and
    the total count of episode ends.  ``pi_layers`` ('policy' mode) and
    ``actions`` ('input' mode) as for :func:`rollout`."""
    _check_args(spec, batch, steps, block, action_source, pi_layers)

    def run(seed: int, actions=None):
        state, rsum, dcount = rollout(spec, batch, steps, seed, block,
                                      action_source, actions, pi_layers,
                                      device, threads)
        return state, rsum.sum() / max(batch * steps, 1), dcount.sum()

    return run
