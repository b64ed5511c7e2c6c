"""The PPO trainer's fused acting rollout: a CUDA kernel and its plain twin.

Port of ``make_pallas_train_rollout`` (``ngx/ops/pallas_rollout.py:812``,
kernel ``:1059``) in both of its reset modes.  For each env, over T steps:
LidarInFront obs -> tanh MLP actor -> Gumbel-argmax action -> env step ->
episode-cap truncation -> on done, a fresh state: the counter-RNG reset
(native mode) or the next slot of the env's pool (pool mode, ``:946-1016``,
``:1203-1227``).  It emits the trajectory (obs before each step, action,
reward, done) and the final state, and in pool mode each env's cap base.

:func:`train_rollout` is the wrapper: on a CUDA state it launches
``csrc/train_rollout.cu`` (built by :mod:`ngx_torch.ops._build`) or raises;
on a CPU state it runs :func:`train_rollout_plain`, a Python loop over T of
the plain ``vector``, ``rays``, ``models`` and ``rng`` calls with the same
semantics and the same counter-RNG bits.

Parity hazards (each also named where it is handled):

* RNG block: the stream of env ``e`` is ``(seed + (e // block)*7919, row =
  e % block)`` whatever the CUDA launch geometry (:mod:`ngx_torch.ops.rng`).
* Counters and salts: step ``t`` draws its action with ``ctr = t+1``, salt
  5, over columns ``0..A-1``, and a boundary reset at step ``t`` uses the
  same ``ctr`` (salts 2, 3, ``16+j``, 4).
* Gumbel-argmax is ``logits - log(-log(u + 1e-10) + 1e-10)`` in float32
  with a min-index tie-break (``:965-970``); the kernel's MLP sums in
  another order than torch's matmul, so the two agree except where the top
  two scores are within a few ulps.
* Boundaries: done is ``done | step_count - base >= cap`` (``:976``), with
  ``base`` 0 in native mode; a done env carries the fresh state, and
  ``obs[t]`` is the obs of the state before step ``t`` — the reset obs
  after a boundary.
* Pool mode: the k-th boundary of env ``b`` in a launch (k from 1) restores
  slot ``(k-1) % R`` of its rows ``b*R .. b*R+R-1`` of the pool; the count
  starts at 0 in every launch.  A restore takes the map, inventory, agent,
  facing and step_count from the slot, sets selected -1, last_action 0,
  last_done False, last_reward and last_cost 0, and the base to the slot's
  step_count (``:983-1003``).
* Obs dtype: every obs value is an integer below 256, so float32 is exact;
  the wrapper returns float32 as the JAX ``run`` does (``:1223``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.reset import ResetTables, reset_rows
from ..core.state import EnvState
from ..core.step import make_step
from .rng import _u01, block_streams
from .tables import (c_ints, check_tensor, device_tables, has_novelty,
                     policy_params, seed_i32, unpack_state)

SALT_ACTION = 5

def mlp_logits(x, pi_layers):
    """The policy tower's logits (tanh hidden layers), plain torch."""
    for w, b in pi_layers[:-1]:
        x = torch.tanh(F.linear(x, w, b))
    return F.linear(x, *pi_layers[-1])


def gumbel_scores(logits, seeds, ctr, rows):
    """``logits - log(-log(u + 1e-10) + 1e-10)`` in float32, with ``u`` the
    counter-RNG uniforms of ``(seed, ctr, salt 5, row, action)``
    (pallas_rollout.py:965-966)."""
    cols = torch.arange(logits.shape[-1], dtype=torch.int64,
                        device=logits.device)
    u = _u01(seeds, ctr, SALT_ACTION, rows, cols)
    return logits - torch.log(-torch.log(u + 1e-10) + 1e-10)


def gumbel_argmax(logits, seeds, ctr, rows):
    """Categorical sample by Gumbel-argmax (pallas_rollout.py:965-970);
    ``argmax`` returns the first maximum — the min-index tie-break."""
    return torch.argmax(gumbel_scores(logits, seeds, ctr, rows), dim=1)


def pool_slots(state: EnvState, pool: EnvState) -> int:
    """R, the pool's slots per env: ``pool`` holds ``R`` rows per env of
    ``state``, env ``b``'s slot ``r`` at row ``b*R + r``."""
    B, n = state.batch, pool.batch
    if n < B or n % B:
        raise ValueError(f"a pool of {n} rows for {B} envs: expected R rows "
                         "per env")
    return n // B


def restore(pool: EnvState, slot) -> EnvState:
    """The pool rows ``slot`` as fresh states: map, inventory, agent,
    facing and step_count from the pool, the other fields as a restore sets
    them (pallas_rollout.py:998-1003)."""
    n = slot.shape[0]
    zi = torch.zeros((n,), dtype=torch.int32, device=slot.device)
    zf = torch.zeros((n,), dtype=torch.float32, device=slot.device)
    return EnvState(
        map=pool.map[slot], agent=pool.agent[slot], facing=pool.facing[slot],
        inventory=pool.inventory[slot], selected=zi - 1,
        step_count=pool.step_count[slot], last_action=zi, last_reward=zf,
        last_cost=zf.clone(), last_done=torch.zeros_like(zi, dtype=torch.bool))


@torch.no_grad()
def train_rollout_plain(spec, state: EnvState, pi_layers, seed: int,
                        steps: int, block: int = 128, cap: int = 100,
                        pool: EnvState = None, base=None):
    """The plain twin of the kernel: same arguments and results as
    :func:`train_rollout`, any device."""
    S.check_supported(spec)
    step = make_step(spec, with_obs=False)
    B, dev = state.batch, state.device
    seeds, rows = block_streams(seed, B, block, dev)
    if pool is not None:
        R = pool_slots(state, pool)
        base = (torch.zeros((B,), dtype=torch.int32, device=dev)
                if base is None else base.to(torch.int32).clone())
        n_done = torch.zeros((B,), dtype=torch.int64, device=dev)
    else:
        tab = ResetTables(spec)
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
    obs = step.get_obs(state)
    obs_t = torch.empty((steps, B, obs.shape[1]), dtype=torch.float32,
                        device=dev)
    act = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for t in range(steps):
        ctr = t + 1
        obs_t[t] = obs.to(torch.float32)
        a = gumbel_argmax(mlp_logits(obs_t[t], pi_layers), seeds, ctr, rows)
        state, _, r, d, _ = step(state, a)
        # the cap truncation, then the boundary's fresh state
        d = d | (state.step_count - base >= cap)
        idx = d.nonzero()[:, 0]
        if idx.numel():
            if pool is None:
                fresh = reset_rows(tab, seeds[idx], ctr, rows[idx])
            else:
                n_done[idx] += 1
                slot = idx * R + (n_done[idx] - 1) % R
                fresh = restore(pool, slot)
                base[idx] = fresh.step_count
            state = state.put(idx, fresh)
        obs = step.get_obs(state)
        act[t], rew[t], done[t] = a.to(torch.int32), r, d
    out = (state, obs_t, act, rew, done)
    return out + (base,) if pool is not None else out


@torch.no_grad()
def train_rollout(spec, state: EnvState, pi_layers, seed: int, steps: int,
                  block: int = 128, cap: int = 100, pool: EnvState = None,
                  base=None):
    """Run the acting loop for ``steps`` steps from ``state``.

    ``pi_layers``: the policy tower ``[(weight[out, in], bias[out]), ...]``
    (:meth:`ngx_torch.rl.models.ActorCritic.pi_layers`), output layer last.
    ``block``: the RNG block (128 or 256 envs, as the TPU kernel's block).
    ``pool``: None for native resets, or an :class:`EnvState` of ``B*R``
    fresh states, env ``b``'s slot ``r`` at row ``b*R + r``, for pool
    resets; ``base``: int32[B], each env's cap base (zeros when None).

    Returns ``(state, obs[T, B, OBS_DIM] f32, action[T, B] i32,
    reward[T, B] f32, done[T, B] bool)``, and ``base_out`` int32[B] after
    them in pool mode.  A CPU state runs the plain twin; a CUDA state
    launches the kernel on the current stream (and bumps
    ``train_rollout.launches[mode]``, mode ``'native'`` or ``'pool'``, and
    ``train_rollout.wide_launches[mode]`` too where the spec's map cell is
    wide, more than 64 item ids: the library's ``ngx_wide_cell``) or
    raises."""
    S.check_supported(spec)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        raise ValueError("the acting rollout needs a lidar_in_front spec")
    dev = state.device
    if dev.type == "cpu":
        return train_rollout_plain(spec, state, pi_layers, seed, steps,
                                   block, cap, pool, base)
    if dev.type != "cuda":
        raise ValueError(f"no acting rollout for device {dev}")
    from ._build import load_library
    lib = load_library()
    out = launch(lib, spec, state, pi_layers, seed, steps, block, cap,
                 torch.cuda.current_stream(dev).cuda_stream, pool, base)
    mode = "native" if pool is None else "pool"
    train_rollout.launches[mode] += 1
    if lib.ngx_wide_cell(spec.n_items):
        train_rollout.wide_launches[mode] += 1
    return out


train_rollout.launches = {"native": 0, "pool": 0}
# the launches of the wide-cell instantiations (csrc/ngx_env.cuh wide_cell)
train_rollout.wide_launches = {"native": 0, "pool": 0}

# The tile geometry: ENVS envs and THREADS CUDA threads a block (the tile
# MLP of csrc/ngx_env.cuh); it changes no result (the RNG block is
# logical).  32 x 256 measured fastest of E 16/32/64 x N 16-256 at B 8,192,
# T 64, in both reset modes (PERF.md).  Where a tile of ENVS envs outgrows
# shared memory (the obs width grows with the item ids), the library's
# entry halves it until it fits (csrc/ngx_env.cuh tile_fit).
ENVS = 32
THREADS = 256


def launch(lib, spec, state: EnvState, pi_layers, seed, steps, block, cap,
           stream, pool: EnvState = None, base=None):
    """Check every tensor and the spec against the library's shared memory
    (:func:`~ngx_torch.core.spec.check_kernel_supported`), allocate the
    outputs and call the library's ``ngx_train_rollout`` once (see
    :func:`train_rollout`)."""
    dev = state.device
    B, T = state.batch, int(steps)
    H, I = spec.map_size, spec.n_items
    HW = H * H
    dims, params = policy_params(spec, pi_layers, dev)
    S.check_kernel_supported(spec, dims, lib)
    tab = device_tables(spec, dims, dev)
    obs_dim = dims[0]

    i32 = torch.int32
    ir_in = torch.stack(
        [state.agent[:, 0], state.agent[:, 1], state.facing, state.selected,
         state.step_count, state.last_action, state.last_done.to(i32)],
        dim=1).to(i32).contiguous()
    fr_in = torch.stack([state.last_reward, state.last_cost],
                        dim=1).contiguous()
    map_in = state.map.contiguous()
    inv_in = state.inventory.contiguous()
    check_tensor(map_in, "map", i32, (B, HW), dev)
    check_tensor(inv_in, "inventory", i32, (B, I), dev)
    check_tensor(fr_in, "last_reward/last_cost", torch.float32, (B, 2), dev)

    R, pool_args = 0, [None] * 3
    if pool is not None:
        R = pool_slots(state, pool)
        pool_args = [pool.map.contiguous(), pool.inventory.contiguous(),
                     torch.stack([pool.agent[:, 0], pool.agent[:, 1],
                                  pool.facing, pool.step_count],
                                 dim=1).to(i32).contiguous()]
        for t, name, width in zip(pool_args, ("pool map", "pool inventory",
                                              "pool scalars"), (HW, I, 4)):
            check_tensor(t, name, i32, (B * R, width), dev)
        base = (torch.zeros((B,), dtype=i32, device=dev) if base is None
                else base.to(i32).contiguous())
        check_tensor(base, "base", i32, (B,), dev)
        base_out = torch.empty_like(base)

    outs = (torch.empty_like(map_in), torch.empty_like(ir_in),
            torch.empty_like(fr_in), torch.empty_like(inv_in),
            torch.empty((T, B, obs_dim), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=i32, device=dev),
            torch.empty((T, B), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=torch.bool, device=dev))
    rc = lib.ngx_train_rollout(
        tab.data_ptr(), tab.numel(), c_ints(dims), len(dims),
        map_in.data_ptr(), ir_in.data_ptr(), fr_in.data_ptr(),
        inv_in.data_ptr(), params.data_ptr(), params.numel(),
        seed_i32(seed), B, T, int(block), int(cap), ENVS, THREADS, HW, I,
        *[o.data_ptr() for o in outs],
        *[t.data_ptr() if t is not None else None for t in pool_args], R,
        base.data_ptr() if pool is not None else None,
        base_out.data_ptr() if pool is not None else None,
        int(has_novelty(spec)), stream)
    if rc != 0:
        raise RuntimeError("train_rollout kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    obs, act, rew, done = outs[4:]
    out = (unpack_state(*outs[:4]), obs, act, rew, done)
    return out + (base_out,) if pool is not None else out


def compare_rollouts(a, b):
    """Hold two acting rollouts from the same inputs against each other.

    ``a``, ``b``: ``(state, obs, action, reward, done[, base_out])``
    tuples.  Per env, everything is compared exactly up to that env's first
    action mismatch: obs up to and including that step, reward and done
    before it, and the final state (and base) of envs with no mismatch.
    Returns ``(first[B], bad)``: each env's first mismatching step (T where
    none) and a list of what disagreed inside the compared prefixes (empty
    when they agree)."""
    sa, oa, aa, ra, da = a[:5]
    sb, ob, ab, rb, db = b[:5]
    if len(a) != len(b):
        raise ValueError("one rollout has a base_out and the other not")
    T = aa.shape[0]
    mism = (aa != ab)
    first = torch.where(mism.any(0), mism.to(torch.int8).argmax(0),
                        torch.full_like(mism[0], T, dtype=torch.int64))
    steps = torch.arange(T, device=aa.device)[:, None]
    before = steps < first[None, :]
    bad = []
    if not ((oa == ob).all(-1) | ~(steps <= first[None, :])).all():
        bad.append("obs")
    for name, x, y in (("reward", ra, rb), ("done", da, db)):
        if not ((x == y) | ~before).all():
            bad.append(name)
    clean = first == T
    for name, x in sa.__dict__.items():
        y = getattr(sb, name)
        if not (x[clean] == y[clean]).all():
            bad.append(f"state.{name}")
    if len(a) == 6 and not (a[5][clean] == b[5][clean]).all():
        bad.append("base_out")
    return first, bad
