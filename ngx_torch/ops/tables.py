"""The CUDA kernels' int32 table buffer, state layout and shared-memory
check, shared by :mod:`ngx_torch.ops.train_rollout` and
:mod:`ngx_torch.ops.rollout`.

The buffer holds the spec's tables (ops, costs, recipes, rewards, reset
tables, lidar beams) and the MLP widths: the :data:`HEADER` slots, in this
order, then the arrays their ``O_*`` slots point at.  ``csrc/ngx_env.cuh``
declares the same names in its ``tb`` enum (tests/test_torch_train_rollout.py
holds the two lists equal).  ``F_*`` slots hold float32 bits.

The shared-memory layouts are the library's own: the ``extern "C"`` entries
pick the geometry that fits, and :func:`smem_refusal` asks the library
whether a spec fits at all
(:func:`ngx_torch.core.spec.check_kernel_supported`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core import spec as S
from ..core.reset import ResetTables
from ..core.state import EnvState
from .rays import beam_offsets, inventory_keep, lidar_slots

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
    "CRAFT_VARIANT", "CRAFT_NAG", "STICK_R", "TAP_R", "PLANK_I", "STICK_I",
    "TAP_I", "GOAL_FRONT_MODE", "GOAL_FRONT", "HAS_DEADEND", "WALL",
    "WALL_COIN", "PLACE_TAP", "TREE", "RESET_TAP", "O_DEADEND",
    "AXE_MODE", "AXE_ID", "AXE_BI", "F_AXE_COST", "FENCE_MODE", "FENCE_ID",
    "CRATE_ID", "O_CRATE", "FIRE_ITEM", "F_FIRE_REWARD", "HAS_GRAB",
    "O_ENTITY", "NEDIT", "O_EDITS", "LANE_BITS",
    "N_TAB",
)


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.int32)


def _index(names, name, missing):
    return names.index(name) if name in names else missing


def kernel_tables(sp, dims=()) -> np.ndarray:
    """The spec's tables and the MLP widths ``dims = (OBS_DIM, *hidden, A)``
    (empty for a kernel run without a policy) as the kernels' int32 buffer
    (layout: :data:`HEADER`).  The lidar beams are there only for a
    LidarInFront spec, the one obs the kernels compute."""
    S.check_supported(sp)
    rt = ResetTables(sp)
    I, R = sp.n_items, sp.n_recipes
    ops = set(np.asarray(sp.action_op).tolist())
    keep = inventory_keep(sp)
    lidar = sp.obs_mode == S.OBS_LIDAR_FRONT
    nb, kr = (sp.lidar_num_beams, sp.lidar_max_range) if lidar else (0, 0)
    head = dict(
        H=sp.map_size, I=I, A=sp.n_actions, R=R, NB=nb, K=kr,
        NSLOT=len(sp.lidar_items) if lidar else 0, NKEEP=len(keep),
        NPLACE=len(rt.placements), NINT=len(rt.interior_ids),
        NH=max(len(dims) - 2, 0), OBS_DIM=dims[0] if dims else 0,
        RANDOM_INV=int(rt.random_inv),
        TABLE_ID=sp.crafting_table_id, ADJ_ITEM=sp.place_adjacent_item,
        EXTRACT_AMOUNT=sp.extract_amount, EXTRACT_YIELD=sp.extract_yield_item,
        EXTRACT_SRC=sp.extract_source_item,
        RUBBER=_index(sp.items, "rubber", 0),
        HAS_BREAK=int(S.OP_BREAK in ops),
        HAS_CRAFT=int(S.OP_CRAFT in ops and R > 0),
        GOAL_ANY=int(sp.goal_any),
        F_REWARD_STEP=_f32_bits(sp.reward_step)[0],
        F_REWARD_INTER=_f32_bits(sp.reward_intermediate)[0],
        F_REWARD_DONE=_f32_bits(sp.reward_done)[0],
        F_CRAFT_SUCCESS=_f32_bits(sp.craft_success_reward)[0],
        F_BREAK_COST=_f32_bits(sp.break_cost)[0],
        # the legacy step families and the irregular resets (step.py
        # :117-124, reset.py); the item indices as ngx's step takes them
        CRAFT_VARIANT=sp.craft_variant, CRAFT_NAG=sp.craft_nag,
        STICK_R=_index(sp.recipe_names, "stick", -1),
        TAP_R=_index(sp.recipe_names, "tree_tap", -1),
        PLANK_I=_index(sp.items, "plank", 0),
        STICK_I=_index(sp.items, "stick", 0),
        TAP_I=_index(sp.items, "tree_tap", 0),
        GOAL_FRONT_MODE=int(sp.goal_mode == S.GOAL_FRONT_ITEM),
        GOAL_FRONT=sp.goal_front_item,
        HAS_DEADEND=int(bool(np.asarray(sp.deadend_recipes).any())),
        WALL=rt.wall, WALL_COIN=int(rt.wall_coin), PLACE_TAP=int(rt.place_tap),
        TREE=rt.tree, RESET_TAP=rt.tap,
        # the novelty families (step.py:276-327, :580-622): the axe's cost
        # is the float64 product rounded to float32, as JAX rounds it; the
        # fire-wall death reward is -(int(reward_done) // 2)
        AXE_MODE=sp.axe_mode, AXE_ID=sp.axe_id, AXE_BI=int(sp.axe_breakincrease),
        F_AXE_COST=_f32_bits(sp.break_cost * sp.axe_cost_mult)[0],
        FENCE_MODE=sp.fence_restrict, FENCE_ID=sp.fence_id,
        CRATE_ID=sp.crate_id, FIRE_ITEM=sp.fire_item,
        F_FIRE_REWARD=_f32_bits(-(int(sp.reward_done) // 2))[0],
        HAS_GRAB=int(sp.grab_entities_enabled
                     and bool(np.asarray(sp.entity_mask).any())),
        # the percent-fill reset edits, rows (kind, a, b, lo, hi) in
        # injection order (reset.py ResetTables)
        NEDIT=len(rt.edits), LANE_BITS=rt.lane_bits,
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
        O_BEAMS=(beam_offsets(nb, kr, full_circle=True).reshape(-1) if lidar
                 else np.zeros((0,), np.int32)),
        O_SLOT=lidar_slots(sp), O_KEEP=np.asarray(keep, np.int32),
        O_DIMS=np.asarray(dims, np.int32),
        O_DEADEND=np.asarray(sp.deadend_recipes, np.int32),
        O_CRATE=(sp.crate_contents if sp.crate_contents is not None
                 else np.zeros((I,), np.int32)),
        O_ENTITY=np.asarray(sp.entity_mask, np.int32),
        O_EDITS=rt.edits.reshape(-1),
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


def lidar_obs_dim(sp) -> int:
    """The width of a LidarInFront spec's obs: a slot per lidar item a beam,
    then the kept inventory."""
    return sp.lidar_num_beams * len(sp.lidar_items) + len(inventory_keep(sp))


_refusals = {}


def smem_refusal(lib, sp, dims=()):
    """What of ``sp`` the card's shared memory cannot hold, or None
    (:func:`ngx_torch.core.spec.check_kernel_supported`), by the kernels'
    own layouts in ``lib`` (the built library, or a host build of the same
    code): the smallest 'prng'/'input' block (one warp of 32 envs) and,
    where a policy tower of widths ``dims`` runs, the smallest train-kernel
    tile (4 envs), its weights streamed in one-row chunks.  Kept per
    library, spec and widths: the wrappers ask on every launch."""
    key = (getattr(lib, "_name", id(lib)), sp.key, tuple(dims))
    if key not in _refusals:
        hw, ni = sp.map_size ** 2, sp.n_items
        need = []
        tab = kernel_tables(sp)
        edits = has_novelty(sp) and tab[HEADER.index("NEDIT")] > 0
        size = lib.ngx_rollout_smem(int(tab.size), hw, ni, int(edits), 32,
                                    ctypes.byref(ctypes.c_int(1)))
        if size < 0:
            need.append(f"a warp of 32 envs needs {-size} bytes")
        if dims:
            tab = kernel_tables(sp, dims)
            size = lib.ngx_tile_smem(int(tab.size), c_ints(dims), len(dims),
                                     4, hw, ni, 1)
            if size < 0:
                need.append(f"a tile of 4 envs (widths {list(dims)}) needs "
                            f"{-size} bytes")
        _refusals[key] = (
            f"{' and '.join(need)} of shared memory a block, more than the "
            f"{lib.ngx_smem_optin()} bytes of the card's opt-in budget"
            if need else None)
    return _refusals[key]


def has_novelty(sp) -> bool:
    """Does the spec use a novelty family of the step or a reset edit?  The
    kernels run their novelty code only then (a template flag)."""
    ops = set(np.asarray(sp.action_op).tolist())
    return bool(S.OP_CHOP in ops or S.OP_JUMP in ops
                or sp.axe_mode != S.AXE_NONE
                or sp.fence_restrict != S.FENCE_NONE or sp.crate_id >= 0
                or sp.fire_item >= 0 or sp.reset_edits
                or (sp.grab_entities_enabled
                    and bool(np.asarray(sp.entity_mask).any())))


# the kernels' table buffers per (spec, MLP widths, device): copying one from
# pageable host memory on every call would wait for the previous launch
_device_tables = {}


def device_tables(sp, dims, device) -> torch.Tensor:
    key = (sp.key, tuple(dims), str(device))
    if key not in _device_tables:
        _device_tables[key] = torch.as_tensor(kernel_tables(sp, dims)).to(device)
    return _device_tables[key]


# the header slots of the same buffers, host memory for a C argument
_host_headers = {}


def host_header(sp, dims):
    """The :data:`HEADER` slots of :func:`kernel_tables` as a host ``int32``
    C array: what ``csrc/rollout.cu`` takes by value beside the table."""
    key = (sp.key, tuple(dims))
    if key not in _host_headers:
        _host_headers[key] = c_ints(kernel_tables(sp, dims)[:len(HEADER)])
    return _host_headers[key]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default of every
    entry point) names the current card, and raises where there is none —
    never a fallback to the CPU, which runs only when asked for."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device}: no CUDA device here; pass device='cpu' to "
                "run the plain twins on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_tensor(t: torch.Tensor, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel argument must be."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def tower_buffer(pi_layers) -> torch.Tensor:
    """The tower as the kernels' tile MLP reads it (``csrc/ngx_env.cuh``):
    one flat float32 buffer holding, per layer, ``W^T`` as ``[din][dp]``
    and then the bias ``[dp]``, with ``dp`` the layer's width padded to a
    multiple of 4 by zeros."""
    parts = []
    for w, b in pi_layers:
        dout = w.shape[0]
        rows = torch.cat([w.t(), b[None, :]])            # [din + 1, dout]
        parts.append(F.pad(rows, (0, -dout % 4)).reshape(-1))
    return torch.cat(parts)


def policy_params(spec, pi_layers, device):
    """The policy tower ``[(weight[out, in], bias[out]), ...]`` as the
    kernels take it: its widths ``[OBS_DIM, *hidden, A]`` and
    :func:`tower_buffer`, after checking each tensor against the spec's
    LidarInFront obs width and action count."""
    dims = [pi_layers[0][0].shape[1]] + [w.shape[0] for w, _ in pi_layers]
    if dims[-1] != spec.n_actions:
        raise ValueError(f"policy emits {dims[-1]} logits for "
                         f"{spec.n_actions} actions")
    want = lidar_obs_dim(spec)
    if dims[0] != want:
        raise ValueError(f"policy input width {dims[0]}, obs width {want}")
    for (w, b), d_in, d_out in zip(pi_layers, dims[:-1], dims[1:]):
        check_tensor(w, "weight", torch.float32, (d_out, d_in), device)
        check_tensor(b, "bias", torch.float32, (d_out,), device)
    return dims, tower_buffer(pi_layers)


def c_ints(values):
    """A host ``int32`` array for a C argument (``ctypes``)."""
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def seed_i32(seed: int) -> int:
    """The seed as the kernels take it, an int32; the twins read the same
    uint32 bits."""
    return (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31


def unpack_state(map_out, ir_out, fr_out, inv_out) -> EnvState:
    """The state the kernels write: the map, the int registers ``[B, 7]``
    (row, col, facing, selected, step_count, last_action, last_done), the
    float registers ``[B, 2]`` (last_reward, last_cost) and the inventory."""
    return EnvState(
        map=map_out, agent=ir_out[:, 0:2], facing=ir_out[:, 2],
        inventory=inv_out, selected=ir_out[:, 3], step_count=ir_out[:, 4],
        last_action=ir_out[:, 5], last_reward=fr_out[:, 0],
        last_cost=fr_out[:, 1], last_done=ir_out[:, 6] != 0)
