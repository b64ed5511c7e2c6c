"""The ``stepping-novelty`` traffic: the ``stepping`` mix's closed loop of
``throughput_fn`` calls (the counter 'prng' kernel: uniform actions,
auto-reset) on a configuration with a ``novelty``, so every reset the
kernel draws carries the novelty's edit and the kernel runs its novelty
instantiation.

The cell is :class:`portbench.runners.stepping.Cell` with the spec built
under the novelty; the reference for the check is
:mod:`portbench.reference.novelty`."""

from __future__ import annotations

import torch

from ..harness import standin_fault
from ..reference import novelty
from . import stepping as base
from .stepping import FAULTS, covers_sample, tiny  # noqa: F401  (stepping's)


def standin(config, traffic, seed, device, mode) -> dict:
    """The numbers the cell reads when the novelty reference, with its
    reward sums in bfloat16 (``control``), answers the calls ``seed``
    samples."""
    standin_fault(mode, FAULTS)
    seed_of, sampled = base.schedule(traffic, seed)
    return novelty.standin_stepping(config, traffic,
                                    [seed_of(i) for i in sampled], device,
                                    torch.bfloat16)


def check(config, traffic, samples, device) -> dict:
    """The cell's numbers for ``samples``, judged on the fenced spec."""
    return novelty.check_stepping(config, traffic, samples, device)


class Cell(base.Cell):
    def __init__(self, config, traffic, seed, device="cuda"):
        from ngx_torch.novelty import inject_novelty
        from ngx_torch.presets import make_spec
        from ngx_torch.transforms import lidar_in_front
        from ngx_torch.vector import throughput_fn

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.spec = lidar_in_front(inject_novelty(make_spec(config["env_id"]),
                                                  *config["novelty"]))
        self.B, self.T = int(traffic["batch"]), int(traffic["steps"])
        self.run = throughput_fn(self.spec, self.B, self.T,
                                 device=self.device)
        self.seed_of, self.sampled = base.schedule(traffic, seed)
        self.i = 0
        self.run(self.seed_of(-1))           # builds or loads the kernels
        base.sync(self.device)
        self.kept = []

    def check(self) -> dict:
        return check(self.config, self.traffic, self.samples, self.device)
