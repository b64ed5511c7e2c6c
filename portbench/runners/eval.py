"""The ``eval`` traffic: ``make_eval(spec, cap)`` (ngx's keys) and its
``run(params, key, episodes)`` on the configuration's policy, one
evaluation after another (the path ``eval_agents`` and
``evaluate_checkpoint`` take).

How long an evaluation runs depends on its key: the loop stops once every
episode is done.  So every seed evaluates the same pool of ``pool`` keys,
``fold_in(key(pool_seed), j + 1)``, in an order drawn from the seed, and
the window runs whole cycles of the pool, at least one: the cycle under
way at the deadline finishes.

Set-up loads the policy's state dict, builds the evaluator and runs one
evaluation outside the pool.  Each evaluation returns its metrics to the
host, as the program's ``run`` does.  The first evaluation of ``samples``
pool keys drawn from the seed is kept for the check, with the policy's
logits of each of its steps (a forward hook on every module, which keeps
the ``ActorCritic``'s)."""

from __future__ import annotations

import copy
import math
import random
import time

import torch

from ..harness import ROOT, standin_fault
from ..reference import checks

FAULTS = ()                       # the control alone


def schedule(traffic, seed):
    """``(order, sampled)``: the pool keys' order for this seed and the pool
    keys whose first evaluation the check judges."""
    rng = random.Random(seed)
    order = list(range(int(traffic["pool"])))
    rng.shuffle(order)
    return order, sorted(rng.sample(order, int(traffic["samples"])))


def tiny(config, traffic, card=False):
    """Copies of ``config`` and ``traffic`` at the tests' sizes: on the CPU
    64 episodes of at most 30 steps, a pool of 2 keys, both sampled; with
    ``card``, the cell's own."""
    traffic = dict(traffic)
    if not card:
        traffic.update(episodes=64, cap=30, pool=2, samples=2)
    return copy.deepcopy(config), traffic


def standin(config, traffic, seed, device, mode) -> dict:
    """The numbers the cell reads when the reference, in TF32
    (``control``), evaluates the pool keys ``seed`` samples."""
    standin_fault(mode, FAULTS)
    _, sampled = schedule(traffic, seed)
    pool_seed = int(traffic["pool_seed"])
    return checks.standin_eval(config, traffic,
                               [(pool_seed, j + 1) for j in sampled],
                               device, root=str(ROOT))


def check(config, traffic, samples, device) -> dict:
    """The cell's numbers for ``samples``, ``((pool_seed, j + 1), metrics,
    logits)`` of the evaluations the program answered."""
    return checks.check_eval(config, traffic, samples, device,
                             root=str(ROOT))


def covers_sample(traffic) -> bool:
    """Always: a traced run is one whole cycle of the pool."""
    return True


class Cell:
    def __init__(self, config, traffic, seed, device="cuda"):
        from ngx_torch.ops import threefry as TF
        from ngx_torch.presets import make_spec
        from ngx_torch.rl.evaluate import make_eval
        from ngx_torch.utils.checkpoint import restore_checkpoint

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.TF = TF
        self.pool_key = TF.key(int(traffic["pool_seed"]))
        self.params = restore_checkpoint(
            str(ROOT / config["eval_policy"]))["params"]
        self.episodes = int(traffic["episodes"])
        self.run = make_eval(make_spec(config["env_id"]),
                             cap=int(traffic["cap"]), device=self.device)
        self.order, self.sampled = schedule(traffic, seed)
        self.i = 0
        self.kept = []
        self.run(self.params, TF.fold_in(self.pool_key, 0), self.episodes)

    def _evaluate(self, spans=False):
        j = self.order[self.i % len(self.order)]
        keep = self.i < len(self.order) and j in self.sampled
        logits = []
        hook = None
        if keep:
            # the policy's logits of each step, as the program computed them
            def record(module, inputs, output):
                if type(module).__name__ == "ActorCritic":
                    logits.append(output[0].detach().clone())

            hook = torch.nn.modules.module.register_module_forward_hook(
                record)
        key = self.TF.fold_in(self.pool_key, j + 1)
        try:
            if spans:
                with torch.profiler.record_function(
                        "portbench.make_eval_run"):
                    out = self.run(self.params, key, self.episodes)
            else:
                out = self.run(self.params, key, self.episodes)
        finally:
            if hook is not None:
                hook.remove()
        if keep:
            self.kept.append((j, out, torch.stack(logits)))
        self.i += 1
        return out

    def window(self, seconds: float, ctx: dict):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        evals = failed = 0
        n = len(self.order)
        # whole cycles, at least one: the sampled keys' first evaluations
        while (time.perf_counter() < deadline or self.i % n
               or self.i < n):
            out = self._evaluate()
            evals += 1
            failed += int(not all(math.isfinite(v) for v in out.values()))
        window_s = time.perf_counter() - t0
        ctx.update(episodes=self.episodes * evals, window_s=window_s,
                   attempted=self.episodes * evals,
                   failed=failed * self.episodes)

    def trace(self, ctx: dict, profile):
        """One whole cycle of the pool under the profiler, in the seed's
        order: the sampled keys' first evaluations are kept for the check,
        as in the window, and the per-layer metrics read the same pool in
        every run."""
        n = len(self.order)
        outs = []

        def traced():
            with torch.profiler.record_function("portbench.window"):
                for _ in range(n):
                    outs.append(self._evaluate(spans=True))

        _, tr = profile(traced)
        failed = sum(not all(math.isfinite(v) for v in out.values())
                     for out in outs)
        ctx.update(trace=tr, episodes_traced=self.episodes * n,
                   attempted=self.episodes * n,
                   failed=failed * self.episodes)

    def release(self):
        self.kept = [(j, out, logits.cpu()) for j, out, logits in self.kept]
        self.run = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        pool_seed = int(self.traffic["pool_seed"])
        samples = [((pool_seed, j + 1), out, logits)
                   for j, out, logits in self.kept]
        return check(self.config, self.traffic, samples, self.device)
