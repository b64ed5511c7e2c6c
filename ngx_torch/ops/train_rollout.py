"""The PPO trainer's fused acting rollout: a CUDA kernel and its plain twin.

Port of ``make_pallas_train_rollout`` (``ngx/ops/pallas_rollout.py:812``,
kernel ``:1059``) in its native-reset mode.  For each env, over T steps:
LidarInFront obs -> tanh MLP actor -> Gumbel-argmax action -> env step ->
episode-cap truncation -> on done, the counter-RNG reset.  It emits the
trajectory (obs before each step, action, reward, done) and the final state.

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
* Boundaries: done is ``done | step_count >= cap`` (native resets restart
  the count from 0, ``:976``); a done env carries the fresh reset, and
  ``obs[t]`` is the obs of the state before step ``t`` — the reset obs
  after a boundary.
* Obs dtype: every obs value is an integer below 256, so float32 is exact;
  the wrapper returns float32 as the JAX ``run`` does (``:1223``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.reset import ResetTables
from ..core.state import EnvState
from ..vector import make_vec
from .rays import beam_offsets, inventory_keep, lidar_slots
from .rng import _u01, block_streams

SALT_ACTION = 5

# Layout of the kernel's int32 table buffer: these header slots, in this
# order, then the arrays their O_* slots point at.  csrc/train_rollout.cu
# declares the same names in its ``tb`` enum (tests/test_torch_train_rollout.py
# holds the two lists equal).  F_* slots hold float32 bits.
HEADER = (
    "H", "I", "A", "R", "NB", "K", "NSLOT", "NKEEP", "NPLACE", "NINT", "NH",
    "OBS_DIM", "RANDOM_INV", "TABLE_ID", "ADJ_ITEM", "EXTRACT_AMOUNT",
    "EXTRACT_YIELD", "EXTRACT_SRC", "RUBBER", "HAS_BREAK", "HAS_CRAFT",
    "GOAL_ANY",
    "F_REWARD_STEP", "F_REWARD_INTER", "F_REWARD_DONE", "F_CRAFT_SUCCESS",
    "F_BREAK_COST",
    "O_OP", "O_ARG", "O_COST_OK", "O_COST_FAIL", "O_UNBREAK", "O_BREW",
    "O_BYIELD", "O_RIN", "O_ROUT", "O_RMULTI", "O_CC_OK", "O_CC_MISS",
    "O_CC_NOTAB", "O_GOAL", "O_INV_LO", "O_INV_SPAN", "O_INV_SET", "O_PLACE",
    "O_INT_IDS", "O_INT_FLAT", "O_BASE", "O_BEAMS", "O_SLOT", "O_KEEP",
    "O_DIMS",
    "N_TAB",
)


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.int32)


def kernel_tables(sp, dims) -> np.ndarray:
    """The spec's tables and the MLP widths ``dims = (OBS_DIM, *hidden, A)``
    as the kernel's int32 buffer (layout: :data:`HEADER`)."""
    S.check_supported(sp)
    rt = ResetTables(sp)
    I, R = sp.n_items, sp.n_recipes
    ops = set(np.asarray(sp.action_op).tolist())
    keep = inventory_keep(sp)
    head = dict(
        H=sp.map_size, I=I, A=sp.n_actions, R=R, NB=sp.lidar_num_beams,
        K=sp.lidar_max_range, NSLOT=len(sp.lidar_items), NKEEP=len(keep),
        NPLACE=len(rt.placements), NINT=len(rt.interior_ids),
        NH=len(dims) - 2, OBS_DIM=dims[0], RANDOM_INV=int(rt.random_inv),
        TABLE_ID=sp.crafting_table_id, ADJ_ITEM=sp.place_adjacent_item,
        EXTRACT_AMOUNT=sp.extract_amount, EXTRACT_YIELD=sp.extract_yield_item,
        EXTRACT_SRC=sp.extract_source_item,
        RUBBER=sp.items.index("rubber") if "rubber" in sp.items else 0,
        HAS_BREAK=int(S.OP_BREAK in ops),
        HAS_CRAFT=int(S.OP_CRAFT in ops and R > 0),
        GOAL_ANY=int(sp.goal_any),
        F_REWARD_STEP=_f32_bits(sp.reward_step)[0],
        F_REWARD_INTER=_f32_bits(sp.reward_intermediate)[0],
        F_REWARD_DONE=_f32_bits(sp.reward_done)[0],
        F_CRAFT_SUCCESS=_f32_bits(sp.craft_success_reward)[0],
        F_BREAK_COST=_f32_bits(sp.break_cost)[0],
    )
    arrays = dict(
        O_OP=sp.action_op, O_ARG=sp.action_arg,
        O_COST_OK=_f32_bits(sp.action_cost_success),
        O_COST_FAIL=_f32_bits(sp.action_cost_fail),
        O_UNBREAK=np.asarray(sp.unbreakable, np.int32),
        O_BREW=_f32_bits(sp.break_reward), O_BYIELD=sp.break_yield,
        O_RIN=np.asarray(sp.recipes_in).reshape(-1),
        O_ROUT=np.asarray(sp.recipes_out).reshape(-1),
        O_RMULTI=np.asarray(sp.recipe_multi, np.int32),
        O_CC_OK=_f32_bits(sp.craft_cost_success),
        O_CC_MISS=_f32_bits(sp.craft_cost_missing),
        O_CC_NOTAB=_f32_bits(sp.craft_cost_no_table),
        O_GOAL=sp.goal_counts, O_INV_LO=rt.inv_lo, O_INV_SPAN=rt.inv_span,
        O_INV_SET=rt.inv_set, O_PLACE=rt.placements, O_INT_IDS=rt.interior_ids,
        O_INT_FLAT=rt.interior_flat.astype(np.int32), O_BASE=rt.base_flat,
        O_BEAMS=beam_offsets(sp.lidar_num_beams, sp.lidar_max_range,
                             full_circle=True).reshape(-1),
        O_SLOT=lidar_slots(sp), O_KEEP=np.asarray(keep, np.int32),
        O_DIMS=np.asarray(dims, np.int32),
    )
    parts = [np.zeros((len(HEADER),), np.int32)]
    off = len(HEADER)
    for name in HEADER[:-1]:
        if name in head:
            parts[0][HEADER.index(name)] = int(head[name])
        else:
            a = np.asarray(arrays[name]).astype(np.int32).reshape(-1)
            parts[0][HEADER.index(name)] = off
            parts.append(a)
            off += a.size
    parts[0][HEADER.index("N_TAB")] = off
    return np.concatenate(parts)


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


@torch.no_grad()
def train_rollout_plain(spec, state: EnvState, pi_layers, seed: int,
                        steps: int, block: int = 128, cap: int = 100):
    """The plain twin of the kernel: same arguments and results as
    :func:`train_rollout`, any device."""
    S.check_supported(spec)
    vec = make_vec(spec, episode_cap=cap, reset_obs=True)
    B, dev = state.batch, state.device
    seeds, rows = block_streams(seed, B, block, dev)
    obs = vec.get_obs(state)
    obs_t = torch.empty((steps, B, obs.shape[1]), dtype=torch.float32,
                        device=dev)
    act = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for t in range(steps):
        ctr = t + 1
        obs_t[t] = obs.to(torch.float32)
        a = gumbel_argmax(mlp_logits(obs_t[t], pi_layers), seeds, ctr, rows)
        # vec.step: the cap truncation and the boundary reset, drawn from
        # this step's counter in the env's RNG block
        state, obs, r, d, _ = vec.step(state, a, seed, ctr, block)
        act[t], rew[t], done[t] = a.to(torch.int32), r, d
    return state, obs_t, act, rew, done


def _check(t: torch.Tensor, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@torch.no_grad()
def train_rollout(spec, state: EnvState, pi_layers, seed: int, steps: int,
                  block: int = 128, cap: int = 100):
    """Run the acting loop for ``steps`` steps from ``state``.

    ``pi_layers``: the policy tower ``[(weight[out, in], bias[out]), ...]``
    (:meth:`ngx_torch.rl.models.ActorCritic.pi_layers`), output layer last.
    ``block``: the RNG block (128 or 256 envs, as the TPU kernel's block).

    Returns ``(state, obs[T, B, OBS_DIM] f32, action[T, B] i32,
    reward[T, B] f32, done[T, B] bool)``.  A CPU state runs the plain twin;
    a CUDA state launches the kernel on the current stream (and bumps
    ``train_rollout.launches``) or raises."""
    S.check_supported(spec)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        raise ValueError("the acting rollout needs a lidar_in_front spec")
    dev = state.device
    if dev.type == "cpu":
        return train_rollout_plain(spec, state, pi_layers, seed, steps,
                                   block, cap)
    if dev.type != "cuda":
        raise ValueError(f"no acting rollout for device {dev}")
    from ._build import load_library
    out = launch(load_library(), spec, state, pi_layers, seed, steps, block,
                 cap, torch.cuda.current_stream(dev).cuda_stream)
    train_rollout.launches += 1
    return out


train_rollout.launches = 0

# CUDA threads per thread block; it changes no result (the RNG block is
# logical).  32 measured fastest of 32/64/128/256 at B=8192, T=64 (PERF.md)
THREADS = 32
# the kernel's table buffer per (spec, MLP widths, device): copying it from
# pageable host memory on every call would wait for the previous launch
_device_tables = {}


def launch(lib, spec, state: EnvState, pi_layers, seed, steps, block, cap,
           stream):
    """Check every tensor, allocate the outputs and call the library's
    ``ngx_train_rollout`` once (see :func:`train_rollout`)."""
    dev = state.device
    B, T = state.batch, int(steps)
    H, I, A = spec.map_size, spec.n_items, spec.n_actions
    HW = H * H
    dims = [pi_layers[0][0].shape[1]] + [w.shape[0] for w, _ in pi_layers]
    if dims[-1] != A:
        raise ValueError(f"policy emits {dims[-1]} logits for {A} actions")
    key = (spec.key, tuple(dims), str(dev))
    if key not in _device_tables:
        _device_tables[key] = torch.as_tensor(kernel_tables(spec, dims)).to(dev)
    tab = _device_tables[key]
    obs_dim = dims[0]
    want = spec.lidar_num_beams * len(spec.lidar_items) \
        + len(inventory_keep(spec))
    if obs_dim != want:
        raise ValueError(f"policy input width {obs_dim}, obs width {want}")
    for (w, b), d_in, d_out in zip(pi_layers, dims[:-1], dims[1:]):
        _check(w, "weight", torch.float32, (d_out, d_in), dev)
        _check(b, "bias", torch.float32, (d_out,), dev)
    params = torch.cat([p.reshape(-1) for wb in pi_layers for p in wb])

    i32 = torch.int32
    ir_in = torch.stack(
        [state.agent[:, 0], state.agent[:, 1], state.facing, state.selected,
         state.step_count, state.last_action, state.last_done.to(i32)],
        dim=1).to(i32).contiguous()
    fr_in = torch.stack([state.last_reward, state.last_cost],
                        dim=1).contiguous()
    map_in = state.map.contiguous()
    inv_in = state.inventory.contiguous()
    _check(map_in, "map", i32, (B, HW), dev)
    _check(inv_in, "inventory", i32, (B, I), dev)
    _check(fr_in, "last_reward/last_cost", torch.float32, (B, 2), dev)

    maxw = max(dims)
    scratch = torch.empty((2 * maxw * B,), dtype=torch.float32, device=dev)
    outs = (torch.empty_like(map_in), torch.empty_like(ir_in),
            torch.empty_like(fr_in), torch.empty_like(inv_in),
            torch.empty((T, B, obs_dim), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=i32, device=dev),
            torch.empty((T, B), dtype=torch.float32, device=dev),
            torch.empty((T, B), dtype=torch.bool, device=dev))
    # the kernel takes the int32 seed; the twin reads the same uint32 bits
    seed_i32 = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31
    rc = lib.ngx_train_rollout(
        tab.data_ptr(), tab.numel(), map_in.data_ptr(), ir_in.data_ptr(),
        fr_in.data_ptr(), inv_in.data_ptr(), params.data_ptr(),
        params.numel(), seed_i32, B, T, int(block), int(cap), THREADS,
        HW, I, scratch.data_ptr(), maxw, *[o.data_ptr() for o in outs],
        stream)
    if rc != 0:
        raise RuntimeError("train_rollout kernel launch failed: "
                           + lib.ngx_error_string(rc).decode())
    map_out, ir_out, fr_out, inv_out, obs, act, rew, done = outs
    out_state = EnvState(
        map=map_out, agent=ir_out[:, 0:2], facing=ir_out[:, 2],
        inventory=inv_out, selected=ir_out[:, 3], step_count=ir_out[:, 4],
        last_action=ir_out[:, 5], last_reward=fr_out[:, 0],
        last_cost=fr_out[:, 1], last_done=ir_out[:, 6] != 0)
    return out_state, obs, act, rew, done


def compare_rollouts(a, b):
    """Hold two acting rollouts from the same inputs against each other.

    ``a``, ``b``: ``(state, obs, action, reward, done)`` tuples.  Per env,
    everything is compared exactly up to that env's first action mismatch:
    obs up to and including that step, reward and done before it, and the
    final state of envs with no mismatch.  Returns ``(first[B], bad)``:
    each env's first mismatching step (T where none) and a list of what
    disagreed inside the compared prefixes (empty when they agree)."""
    sa, oa, aa, ra, da = a
    sb, ob, ab, rb, db = b
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
    return first, bad
