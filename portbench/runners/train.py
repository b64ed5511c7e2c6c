"""The ``train`` traffic: the CLI's keyed PPO update loop in a closed loop.

Update ``u`` runs ``train_step(carry, fold_in(key, u + 1))`` and the
metrics are fetched to the host once every ``fetch_every`` updates, as
``ngx_torch/cli/train.py``'s ``run_updates`` does, without its logs or
checkpoints.  A configuration with a ``chain`` trains its last stage by
``make_train_chain`` and refreshes the pool before every update ``u`` with
``u % updates_per_refresh == 0``, on ``fold_in(key, 500_000 + u)``.

Set-up builds the trainer from the seed's key and runs the first block of
updates; the first ``checked_updates`` of them are recorded for the check
(their trajectories, loss terms, the first gradient as the optimizer took
it, the parameters before and after).  The window runs whole blocks; the
reference follows the recorded updates once the window has closed."""

from __future__ import annotations

import contextlib
import copy
import math
import time

import torch

from ..harness import ROOT, standin_fault
from ..reference import checks
from ..yardstick import kernel_bound_ms, update_ops


@contextlib.contextmanager
def recording(modules, sink):
    """Record every acting rollout of the trainer: the ``train_rollout``
    name of each module in ``modules`` wrapped so that its outputs are
    appended to ``sink``."""
    originals = [m.train_rollout for m in modules]
    inner = originals[0]

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    for m in modules:
        m.train_rollout = wrapped
    try:
        yield
    finally:
        for m, f in zip(modules, originals):
            m.train_rollout = f


# half of every minibatch dropped, an action altered where it is produced,
# the parameters left unchanged
FAULTS = ("half", "alter", "unchanged")


def tiny(config, traffic, card=False):
    """Copies of ``config`` and ``traffic`` at the tests' sizes: on the CPU
    B 256, T 8, 2 epochs of 2 minibatches, cap 20, a pool of 128 and the
    metrics fetched every 4 updates; with ``card``, B 2,048, T 32."""
    config, traffic = copy.deepcopy(config), dict(traffic)
    if card:
        config["ppo"].update(num_envs=2048, rollout_steps=32)
        return config, traffic
    config["ppo"].update(num_envs=256, rollout_steps=8, epochs=2,
                         num_minibatches=2, episode_cap=20)
    config["pool_size"] = 128
    traffic["fetch_every"] = 4
    return config, traffic


def standin(config, traffic, seed, device, mode) -> dict:
    """The numbers the cell reads when the reference stands in for the
    program: in TF32 (``control``) or with a fault of :data:`FAULTS`."""
    fault = standin_fault(mode, FAULTS)
    return checks.standin_train(config, traffic, seed, device,
                                tf32=fault is None, fault=fault,
                                root=str(ROOT))


def covers_sample(traffic) -> bool:
    """Always: the check judges set-up's first updates, which every run
    makes."""
    return True


class Cell:
    """One process's trainer for a cell of the ``train`` mix."""

    def __init__(self, config, traffic, seed, device="cuda"):
        from ngx_torch.ops import threefry as TF
        from ngx_torch.rl import curriculum, train
        from ngx_torch.rl.models import ActorCritic
        from ngx_torch.rl.train import PPOConfig
        from ngx_torch.utils.checkpoint import restore_checkpoint

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
        self.chain = config.get("chain")
        self.refresh_every = int(config.get("updates_per_refresh", 0))
        self.stage_rows = 0          # rows the stage policies forwarded
        self.bc_rows = 0
        if self.chain:
            import numpy as np

            stages = []
            for env in self.chain[:-1]:
                sd = restore_checkpoint(str(ROOT / config["stage_policies"]
                                            .format(env=env)))["params"]
                n_hidden = sum(1 for k in sd if k.startswith("pi_")
                               and k.endswith(".weight")) - 1
                model = ActorCritic(sd["pi_0.weight"].shape[1],
                                    sd["pi_out.weight"].shape[0],
                                    [sd[f"pi_{i}.weight"].shape[0]
                                     for i in range(n_hidden)])
                model.load_state_dict(sd)
                model.register_forward_hook(self._count_stage_rows)
                stages.append(model)
            self.stage_dims = [[m.pi_0.in_features, *m.hidden,
                                m.pi_out.out_features] for m in stages]
            with np.load(ROOT / config["bc_anchor"]) as z:
                bc_data = (np.asarray(z["obs"], np.float32),
                           np.asarray(z["actions"], np.int64).reshape(-1))
            self.bc_rows = bc_data[0].shape[0]
            init, self.step = curriculum.make_train_chain(
                self.cfg, self.chain, stages, bc_data=bc_data,
                pool_size=config["pool_size"], device=self.device)
            self.modules = [curriculum]
        else:
            init, self.step = train.make_train(self.cfg, device=self.device)
            self.modules = [train]
        self.carry = init(self.key)
        model = self.carry[0].model
        self.obs_dim = model.pi_0.in_features
        self.n_actions = model.pi_out.out_features
        self.mode = "pool" if self.chain else self.step.reset_source
        self.u = 0
        self.record = self._first_block()

    # ---- the program's updates ---------------------------------------------
    def _count_stage_rows(self, module, inputs, output):
        self.stage_rows += int(inputs[0].shape[0])

    def _update(self, spans=False):
        """One update of the CLI's loop: the refresh where it is due, then
        the train step; returns its metrics."""
        span = (torch.profiler.record_function if spans
                else lambda name: contextlib.nullcontext())
        if self.chain and self.u % self.refresh_every == 0:
            with span("portbench.refresh_pool"):
                self.carry = self.step.refresh_pool(
                    self.carry, self.TF.fold_in(self.key, 500_000 + self.u))
        with span("portbench.train_step"):
            self.carry, m = self.step(self.carry,
                                      self.TF.fold_in(self.key, self.u + 1))
        self.u += 1
        return m

    def _block(self, events=None, spans=False):
        """``K`` updates, then the metrics fetched to the host (the CLI's
        ``.cpu().tolist()``); ``events`` collects a CUDA event recorded
        after each update.  Returns the fetched rows."""
        stacked = []
        for _ in range(self.K):
            m = self._update(spans)
            stacked.append(torch.stack([v.to(torch.float64)
                                        for v in m.values()]))
            if events is not None:
                events.append(self._mark())
        ctx = (torch.profiler.record_function("portbench.fetch_metrics")
               if spans else contextlib.nullcontext())
        with ctx:
            return torch.stack(stacked).cpu()

    def _first_block(self):
        """The set-up block: ``K`` updates, the first ``checked`` recorded."""
        model, opt = self.carry[0].model, self.carry[0].opt
        params = list(model.parameters())
        rec = dict(theta0=[p.detach().cpu().clone() for p in params],
                   rollouts=[], terms=[], grad1=None, theta=None, pools=[])
        beta1 = opt.param_groups[0]["betas"][0]

        def first_grad(optimizer, args, kwargs):
            if rec["grad1"] is None:
                rec["grad1"] = [(optimizer.state[p]["exp_avg"]
                                 / (1 - beta1)).cpu() for p in params]

        handle = opt.register_step_post_hook(first_grad)
        if self.chain:
            rec["start"] = checks.state_rows(self.carry[1])
        stacked = []
        try:
            for i in range(self.K):
                if i < self.checked:
                    sink = []
                    with recording(self.modules, sink):
                        m = self._update()
                    rec["rollouts"].append(
                        [x.cpu() for x in sink[0][1:5]])
                    rec["terms"].append(torch.stack(
                        [m["pg_loss"], m["v_loss"], m["entropy"]]).cpu())
                    if self.chain and i == 0:
                        rec["pools"].append(checks.state_rows(
                            self.carry[5]))
                    if i == self.checked - 1:
                        rec["theta"] = [p.detach().cpu().clone()
                                        for p in params]
                else:
                    m = self._update()
                stacked.append(torch.stack([v.to(torch.float64)
                                            for v in m.values()]))
        finally:
            handle.remove()
        torch.stack(stacked).cpu()
        return rec

    # ---- the window --------------------------------------------------------
    def _mark(self):
        """A CUDA event recorded on the current stream (on the CPU, where
        the tests run, the host clock)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, ctx: dict):
        B, T = self.cfg.num_envs, self.cfg.rollout_steps
        self._sync()
        events = []
        failed = 0
        t0 = time.perf_counter()
        start = self._mark()
        deadline = t0 + seconds
        updates = 0
        while True:
            rows = self._block(events)
            updates += self.K
            failed += int((~torch.isfinite(rows)).any(1).sum())
            if time.perf_counter() >= deadline:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        marks = [start] + events
        step_ms = [(b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)
                   for a, b in zip(marks[:-1], marks[1:])]
        ctx.update(env_steps=B * T * updates, window_s=window_s,
                   step_ms=step_ms, attempted=updates, failed=failed)

    # ---- the traced run ----------------------------------------------------
    def trace(self, ctx: dict, profile):
        """A window of ``ctx['seconds']`` as ``--trace 0`` runs it (the
        loop's rate and update tail, read per layer here), then three
        blocks: one plain (the whole step's wall time for ``train_mfu``),
        one timed by phase (``PhaseTimer``, which synchronizes after each
        phase), one under the profiler."""
        B, T = self.cfg.num_envs, self.cfg.rollout_steps
        self.window(ctx.get("seconds", 0.0), ctx)
        rows0 = self.stage_rows
        t0 = time.perf_counter()
        self._block()
        self._sync()
        step_s = (time.perf_counter() - t0) / self.K
        stage_rows = self.stage_rows - rows0
        self.step.phases = {}
        self._block()
        phases, self.step.phases = self.step.phases, None

        def traced():
            with torch.profiler.record_function("portbench.window"):
                self._block(spans=True)

        _, tr = profile(traced)
        cfg = self.cfg
        dims = [self.obs_dim, *cfg.hidden, self.n_actions]
        ops = update_ops(self.obs_dim, cfg.hidden, self.n_actions, B, T,
                         cfg.epochs, cfg.num_minibatches,
                         self.bc_rows if cfg.bc_coef > 0 else 0)
        if self.chain:
            from ..yardstick import forward_ops
            # the stage policies' forwards of one block, spread over its
            # updates (only the policy tower's logits are used)
            ops += (stage_rows * forward_ops(self.stage_dims[0])) / self.K
        map_size = int(round(math.sqrt(self.carry[1].map.shape[1])))
        n_items = self.carry[1].inventory.shape[1]
        pool_rows = B * 4 if self.mode == "pool" else 0
        ctx.update(trace=tr, phases=phases, updates=self.K, step_s=step_s,
                   attempted=ctx["attempted"] + 3 * self.K,
                   update_ops=ops,
                   kernel_bound_ms=kernel_bound_ms(
                       map_size, n_items, dims, B, T, "train",
                       pool_rows)[0],
                   kernel_match="train_rollout",
                   refreshes=(self.K // self.refresh_every
                              if self.chain else 0))

    # ---- the check ---------------------------------------------------------
    def release(self):
        self.carry = None
        self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return checks.check_train(self.config, self.traffic, self.seed,
                                  self.record, self.device, root=str(ROOT))

