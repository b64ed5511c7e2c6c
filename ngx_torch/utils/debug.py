"""NGX_DEBUG=1 — the invariant asserts; the port of ``ngx/utils/debug.py``.

Off by default, at no cost: nothing wraps the step or the reset.  With
``NGX_DEBUG=1`` in the environment when a step or reset is built,
:func:`ngx_torch.core.step.make_step`, :func:`ngx_torch.core.reset.
counter_reset` and :class:`ngx_torch.vector.VecEnv`'s resets check the
state they produce: one batched reduction to six flags per env and one
device-to-host read of them per call (where ngx makes one host callback),
raising ``AssertionError`` with ngx's text for the first violated
invariant.

Checked invariants (per step and per reset):
  * inventory quantities are non-negative
  * the wall ring is intact (novelties may *replace* wall with another
    unbreakable item — e.g. firewall — so the check is ring != air, not
    ring == wall)
  * the agent is inside the playable area (not on the ring)
  * every map cell holds a valid item id in [0, n_items)
  * facing ∈ {0,1,2,3}; selected ∈ [-1, n_items)

The step also checks its input state's shapes and dtypes
(:func:`validate_state`).  The CUDA kernels cannot run these host-side
checks inside their step loop, so under the flag their entry points refuse
to build (:func:`refuse_kernel`), as ngx's ``make_pallas_*`` functions do.

The env index in the message is the row of the port's batch.  ngx's
asserts on a ``jax.vmap``-ed step run once per env (``jax.debug.callback``
unrolls under vmap), so ngx names index 0 of a batch of one and counts that
env's violations; on one env the two texts are the same.
"""

from __future__ import annotations

import os

import numpy as np
import torch

INVARIANTS = (
    "inventory >= 0",
    "wall ring intact (ring cells != air)",
    "agent inside playable area",
    "map cell ids in [0, n_items)",
    "facing in {0,1,2,3}",
    "selected in [-1, n_items)",
)


def enabled() -> bool:
    """Debug mode is resolved at build time (``make_step``, a reset, a
    ``VecEnv``, a kernel entry), so flipping the env var affects what is
    built afterwards only."""
    return os.environ.get("NGX_DEBUG", "") not in ("", "0")


def validate_state(sp, state) -> None:
    """Shape and dtype asserts on an :class:`EnvState` (host only, no
    device work)."""
    H, I = sp.map_size, sp.n_items
    checks = (
        (tuple(state.map.shape[-1:]) == (H * H,), "map shape"),
        (tuple(state.agent.shape[-1:]) == (2,), "agent shape"),
        (tuple(state.inventory.shape[-1:]) == (I,), "inventory shape"),
        (state.map.dtype == torch.int32, "map dtype"),
        (state.inventory.dtype == torch.int32, "inventory dtype"),
        (state.facing.dtype == torch.int32, "facing dtype"),
    )
    for ok, name in checks:
        assert ok, f"NGX_DEBUG state validation failed: {name}"


def _host_assert(flags, where):
    flags = np.asarray(flags)
    if flags.all():
        return
    bad = np.argwhere(~flags.reshape(-1, flags.shape[-1]))
    env_i, inv_i = (int(bad[0][0]), int(bad[0][1]))
    raise AssertionError(
        f"NGX_DEBUG: invariant violated after {where}: "
        f"{INVARIANTS[inv_i]} (env index {env_i} of the callback batch; "
        f"{len(bad)} total violations)")


def kernel_asserts(sp, state, where: str) -> None:
    """Raise ``AssertionError`` naming the first violated invariant of
    ``state`` (batched), its env index and the count of violations.  Only
    call when :func:`enabled`: the ``bool[B, 6]`` flags are one reduction
    on the state's device and one read to the host."""
    H, I = sp.map_size, sp.n_items
    m = state.map
    cell = torch.arange(H * H, device=m.device)
    ring = ((cell // H == 0) | (cell // H == H - 1) | (cell % H == 0)
            | (cell % H == H - 1))
    r, c = state.agent[..., 0], state.agent[..., 1]
    flags = torch.stack([
        (state.inventory >= 0).all(-1),
        ((m != 0) | ~ring).all(-1),
        (r >= 1) & (r <= H - 2) & (c >= 1) & (c <= H - 2),
        ((m >= 0) & (m < I)).all(-1),
        (state.facing >= 0) & (state.facing < 4),
        (state.selected >= -1) & (state.selected < I),
    ], dim=-1)
    _host_assert(flags.cpu().numpy(), where)


def refuse_kernel(alternative: str) -> None:
    """Under the flag, raise ``RuntimeError`` for a CUDA kernel entry, as
    ngx's ``make_pallas_*`` functions do (``pallas_rollout.py:551-559``,
    ``:871-874``); ``alternative`` names the path that runs with the
    asserts."""
    if enabled():
        raise RuntimeError(
            "NGX_DEBUG=1 is unsupported in the CUDA rollout path (the "
            "host-side asserts cannot run inside the kernel's step loop); "
            f"unset NGX_DEBUG or use {alternative}")
