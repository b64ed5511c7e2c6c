"""Checkpoints as ``torch.save`` files — the port of
``ngx/utils/checkpoint.py``'s ``save_pytree`` / ``restore_pytree``
(``:21``, ``:28``), which write orbax directories.

A checkpoint is one file holding a dict: ``"params"`` (a model's state
dict), and optionally ``"opt_state"`` (an optimizer's state dict),
``"env_state"`` (an :class:`~ngx_torch.core.state.EnvState`, saved as its
fields) and ``"config"`` (plain Python values).  A training run writes
``<ckpt>/best.pt``, ``<ckpt>/final.pt`` and ``<ckpt>/resume.pt`` where ngx
writes the directories ``best/``, ``final/`` and ``resume/``.  Tensors are
saved on the CPU, and a read loads them there with
``torch.load(..., weights_only=True)``, which builds no arbitrary object.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..core.state import EnvState


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, EnvState):
        return {f.name: _to_cpu(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_checkpoint(path: str, tree: dict) -> str:
    """Write ``tree`` (see the module docstring) to the file ``path``,
    creating its directory; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_cpu(tree), path)
    return path


def restore_checkpoint(path: str, device="cpu") -> dict:
    """The dict :func:`save_checkpoint` wrote, its tensors on ``device``
    and its ``"env_state"``, where there is one, an :class:`EnvState`."""
    tree = torch.load(path, map_location=device, weights_only=True)
    if tree.get("env_state") is not None:
        tree["env_state"] = EnvState(**tree["env_state"])
    return tree
