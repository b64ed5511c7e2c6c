"""The ``stepping`` traffic: ``vector.throughput_fn(spec, batch, steps)``
(the counter 'prng' kernel: uniform actions, auto-reset) called in a
closed loop, call ``i`` on seed ``base + i * stride``, with nothing read
back between calls.

Set-up builds the function and makes one call (the kernel library is
built or loaded there).  The window enqueues calls until its time is up
and at least ``sample_from`` calls were made, then synchronizes; a sample of calls drawn from the seed among the first
``sample_from`` is kept for the check.  The traced run makes
``trace_calls`` calls, at least ``sample_from``, so it keeps the same
sample."""

from __future__ import annotations

import copy
import random
import time

import torch

from ..harness import standin_fault
from ..reference import checks
from ..yardstick import kernel_bound_ms

SEED_STRIDE = 1_013_904_223       # odd, so successive calls' streams differ
FAULTS = ()                       # the control alone


def schedule(traffic, seed):
    """``(seeds, sampled)``: call ``i``'s seed as a function of ``i``, and
    the calls the check judges, drawn from ``seed``."""
    rng = random.Random(seed)
    base = rng.randrange(2 ** 31)
    sampled = sorted(rng.sample(range(int(traffic["sample_from"])),
                                int(traffic["samples"])))
    return (lambda i: (base + i * SEED_STRIDE) % 2 ** 32), sampled


def tiny(config, traffic, card=False):
    """Copies of ``config`` and ``traffic`` at the tests' sizes: on the CPU
    B 1,024, T 48, 2 of the first 4 calls sampled and 4 traced; with
    ``card``, B 8,192."""
    traffic = dict(traffic)
    if card:
        traffic.update(batch=8192)
    else:
        traffic.update(batch=1024, steps=48, sample_from=4, samples=2,
                       trace_calls=4)
    return copy.deepcopy(config), traffic


def standin(config, traffic, seed, device, mode) -> dict:
    """The numbers the cell reads when the reference, with its reward sums
    in bfloat16 (``control``), answers the calls ``seed`` samples."""
    standin_fault(mode, FAULTS)
    seed_of, sampled = schedule(traffic, seed)
    return checks.standin_stepping(config, traffic,
                                   [seed_of(i) for i in sampled], device,
                                   torch.bfloat16)


def check(config, traffic, samples, device) -> dict:
    """The cell's numbers for ``samples``, ``(seed, state rows,
    mean_reward)`` of the calls the program answered."""
    return checks.check_stepping(config, traffic, samples, device)


def covers_sample(traffic) -> bool:
    """Whether a traced run makes every call the check may sample."""
    return int(traffic["trace_calls"]) >= int(traffic["sample_from"])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, config, traffic, seed, device="cuda"):
        from ngx_torch.presets import make_spec
        from ngx_torch.transforms import lidar_in_front
        from ngx_torch.vector import throughput_fn

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.spec = lidar_in_front(make_spec(config["env_id"]))
        self.B, self.T = int(traffic["batch"]), int(traffic["steps"])
        self.run = throughput_fn(self.spec, self.B, self.T,
                                 device=self.device)
        self.seed_of, self.sampled = schedule(traffic, seed)
        self.i = 0
        self.run(self.seed_of(-1))           # builds or loads the kernels
        sync(self.device)
        self.kept = []

    def _call(self, keep=False, spans=False):
        seed = self.seed_of(self.i)
        if spans:
            with torch.profiler.record_function("portbench.throughput_call"):
                out = self.run(seed)
        else:
            out = self.run(seed)
        if keep or self.i in self.sampled:
            self.kept.append((seed, out))
        self.i += 1
        return out

    def window(self, seconds: float, ctx: dict):
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        calls = 0
        means = []
        # the window runs on until the calls the check samples from exist
        sample_from = int(self.traffic["sample_from"])
        while time.perf_counter() < deadline or self.i < sample_from:
            means.append(self._call()[1])
            calls += 1
        sync(self.device)
        window_s = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(means))).sum())
        ctx.update(env_steps=self.B * self.T * calls, window_s=window_s,
                   attempted=calls, failed=failed)

    def trace(self, ctx: dict, profile):
        calls = int(self.traffic["trace_calls"])
        means = []

        def traced():
            with torch.profiler.record_function("portbench.window"):
                for _ in range(calls):
                    means.append(self._call(spans=True)[1])

        _, tr = profile(traced)
        sp = self.spec
        failed = int((~torch.isfinite(torch.stack(means))).sum())
        ctx.update(trace=tr, calls=calls, attempted=calls, failed=failed,
                   kernel_bound_ms=kernel_bound_ms(
                       sp.map_size, sp.n_items, [], self.B, self.T,
                       "prng")[0],
                   kernel_match="rollout_kernel")

    def release(self):
        self.samples = [(seed, checks.state_rows(state), float(mean))
                        for seed, (state, mean) in self.kept]
        self.kept = None
        self.run = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return check(self.config, self.traffic, self.samples, self.device)
