"""Frozen copy of ``resolve_device`` (the port's ``ops/tables.py``), the one
name of that module the frozen copies use."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` names the current card,
    and raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device here")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
