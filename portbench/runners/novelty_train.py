"""The ``train-novelty`` traffic: the ``train`` mix's keyed update loop on
a configuration with a ``novelty``, whose spec has a reset edit, so the
trainer runs in pool mode: each update draws a fresh pool of ``B * R``
resets (``ops/rollout.py`` ``pool_reset``) and the acting kernel restores
its done envs from it.

The cell is :class:`portbench.runners.train.Cell` with the spec built under
the novelty and handed to ``make_train`` (``spec_override``); set-up also
records the program's first pool as ``pool_reset`` returned it, and the
reference for the check is :mod:`portbench.reference.novelty`.  The traced
run adds the pool draw's least time to the context."""

from __future__ import annotations

import contextlib

import torch

from ..harness import standin_fault
from ..reference import checks, novelty
from ..yardstick import kernel_bound_ms
from . import train as base
from .train import covers_sample, tiny  # noqa: F401  (the train mix's)

# the train mix's faults and one pool row altered
FAULTS = novelty.FAULTS


def standin(config, traffic, seed, device, mode) -> dict:
    """The numbers the cell reads when the novelty reference stands in for
    the program: in TF32 (``control``) or with a fault of :data:`FAULTS`."""
    fault = standin_fault(mode, FAULTS)
    return novelty.standin_train(config, traffic, seed, device,
                                 tf32=fault is None, fault=fault)


@contextlib.contextmanager
def first_pool(module, sink):
    """Record the first pool ``module.pool_reset`` returns, as rows on the
    host (copied field by field, so the card holds nothing more), in
    ``sink``."""
    inner = module.pool_reset

    def wrapped(*args, **kwargs):
        pool = inner(*args, **kwargs)
        if not sink:
            sink.append(checks.state_rows(pool.to("cpu")))
        return pool

    module.pool_reset = wrapped
    try:
        yield
    finally:
        module.pool_reset = inner


class Cell(base.Cell):
    """One process's trainer for a cell of the ``train-novelty`` mix."""

    def __init__(self, config, traffic, seed, device="cuda"):
        from ngx_torch.novelty import inject_novelty
        from ngx_torch.ops import threefry as TF
        from ngx_torch.presets import make_spec
        from ngx_torch.rl import train
        from ngx_torch.rl.train import PPOConfig
        from ngx_torch.transforms import lidar_in_front

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.TF = TF
        self.seed = seed
        self.key = TF.key(seed)
        ppo = dict(config["ppo"])
        self.cfg = PPOConfig(env_id=config["env_id"],
                             **{**ppo, "hidden": tuple(ppo["hidden"])})
        self.K = int(traffic["fetch_every"])
        self.checked = int(traffic["checked_updates"])
        self.chain = None
        self.refresh_every = 0
        self.stage_rows = self.bc_rows = 0
        self.spec = lidar_in_front(inject_novelty(make_spec(config["env_id"]),
                                                  *config["novelty"]))
        init, self.step = train.make_train(self.cfg, spec_override=self.spec,
                                           device=self.device)
        self.modules = [train]
        self.carry = init(self.key)
        model = self.carry[0].model
        self.obs_dim = model.pi_0.in_features
        self.n_actions = model.pi_out.out_features
        self.mode = self.step.reset_source
        self.u = 0
        self.record = self._first_block()

    def _first_block(self):
        pools = []
        with first_pool(self.modules[0], pools):
            rec = super()._first_block()
        rec["pools"] = pools
        return rec

    def trace(self, ctx: dict, profile):
        super().trace(ctx, profile)
        rows = self.cfg.num_envs * int(self.config["pool_slots"])
        ctx["pool_draw_bound_ms"] = kernel_bound_ms(
            self.spec.map_size, self.spec.n_items, [], rows, 0, "prng")[0]

    def check(self) -> dict:
        return novelty.check_train(self.config, self.traffic, self.seed,
                                   self.record, self.device)

