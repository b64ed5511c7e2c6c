"""Minimal gym-0.18-style spaces so the facade has ``action_space.n`` /
``observation_space.shape`` without a gym dependency (the reference pins the
2020-era gym API; reference setup.py:14) — the port's copy of
``ngx/compat/spaces.py``."""

from __future__ import annotations

import numpy as np


class Discrete:
    def __init__(self, n):
        self.n = int(n)

    def sample(self, rng=np.random):
        return int(rng.randint(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    def __init__(self, low, high, shape=None, dtype=np.int64):
        self.low = np.asarray(low)
        self.high = np.asarray(high)
        self.shape = tuple(shape) if shape is not None else self.low.shape
        self.dtype = dtype

    def __repr__(self):
        return f"Box{self.shape}"


class Dict:
    def __init__(self, spaces):
        self.spaces = dict(spaces)

    def __getitem__(self, k):
        return self.spaces[k]

    def __repr__(self):
        return f"Dict({list(self.spaces)})"
