"""Host-side decoding of the step's message codes into the reference's exact
``info['message']`` strings (pogostick_v1_env.py:242-359,413-474,
novelty_wrappers.py:63,499-501,955-957,1187) — the port's copy of
``ngx/compat/messages.py``.  The codes are the port's
:class:`~ngx_torch.core.state.StepInfo` ``msg_code`` / ``msg_arg``; a
batched leaf is read at row 0."""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec as S


def _row0(x) -> int:
    """An int, or row 0 of a ``[B]`` tensor or array."""
    if isinstance(x, torch.Tensor):
        return int(x.reshape(-1)[0])
    return int(np.asarray(x).reshape(-1)[0])


def decode_message(spec, code, arg, prev_inventory=None) -> str:
    """``info['message']`` for message ``code`` with parameter ``arg``
    (ints, or ``StepInfo.msg_code`` / ``msg_arg``, row 0);
    ``prev_inventory`` is the pre-step inventory (``int[I]`` or row 0 of
    ``[B, I]``), which the missing-items message needs."""
    code = _row0(code)
    arg = _row0(arg)
    if code == S.MSG_NONE:
        return ""
    if code == S.MSG_BLOCK_IN_PATH:
        return "Block in path"
    if code == S.MSG_CANNOT_BREAK:
        return "Cannot break " + spec.items[arg]
    if code == S.MSG_TAP_PLACED:
        return "Block tree_tap placed"
    if code == S.MSG_BLOCK_EXISTS:
        return ("Block " + spec.items[arg]
                + " already exists when trying to place block")
    if code == S.MSG_ITEM_NOT_FOUND:
        return "Item not found in inventory"
    if code == S.MSG_NO_TREE_NEAR_TAP:
        return "No tree_log near tree_tap"
    if code == S.MSG_NO_TAP:
        return "No tree_tap found"
    if code == S.MSG_MISSING_ITEMS:
        # "Missing items: <qty> <item>, ..." over the recipe's input dict
        # order, listing recipe quantities (pogostick_v1_env.py:432-440);
        # needs the pre-step inventory to know which were missing
        msg = "Missing items: "
        if prev_inventory is not None:
            need = np.asarray(spec.recipes_in[arg])
            inv = (prev_inventory.detach().cpu().numpy()
                   if isinstance(prev_inventory, torch.Tensor)
                   else np.asarray(prev_inventory))
            inv = inv.reshape(-1, inv.shape[-1])[0]
            for item in spec.recipe_input_order[arg]:
                i = spec.items.index(item)
                if inv[i] < need[i]:
                    msg += f"{int(need[i])} {item}, "
        return msg[:-2]
    if code == S.MSG_NEED_TABLE:
        return "Need to be in front of crafting_table"
    if code == S.MSG_CRAFTED:
        return "Crafted " + spec.recipe_names[arg]
    if code == S.MSG_NO_WOOL:
        return "No wool found"
    if code == S.MSG_NEED_AXE:
        return "Cannot break without " + spec.items[arg] + " selected"
    if code == S.MSG_FENCE_RESTRICTION:
        return "Cannot break due to fence restriction"
    if code == S.MSG_DIED_FIREWALL:
        return "You died due to fire_wall"
    if code == S.MSG_CANNOT_CHOP:
        return "Cannot chop " + spec.items[arg]
    return ""
