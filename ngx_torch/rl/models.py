"""Policy/value network — the port of ``ngx/rl/models.py``.

The reference uses SB2's MlpPolicy (two 64-unit tanh layers) over the
LidarInFront vector (reference ``tests/train.py:122``).  The submodules keep
the flax names ``pi_{i}``, ``v_{i}``, ``pi_out`` and ``v_out``; a flax Dense
kernel ``[in, out]`` becomes a torch weight ``[out, in]`` only in
:meth:`ActorCritic.load_flax_params` and :meth:`ActorCritic.from_key`.

:meth:`ActorCritic.from_key` is ngx's ``model.init(key, obs)``: flax's
per-layer keys (:func:`flax_param_key`) and ``lecun_normal`` kernels drawn
by :func:`ngx_torch.ops.threefry.truncated_normal`.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import threefry as TF

# flax's lecun_normal: a normal truncated at two standard deviations, with
# the standard deviation corrected for the truncation
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor):
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def flax_param_key(key, path: str, counter: int) -> torch.Tensor:
    """The key a flax submodule ``path`` of the root hands its
    ``counter``-th ``make_rng('params')`` (1 for a ``Dense`` kernel, 2 for
    its bias): ``LazyRng``'s suffix ``(path, counter)`` folded in by
    ``_fold_in_static`` (flax 0.12.3, ``flax/core/scope.py:110``, ``:745``):
    the SHA-1 of the suffix (a str as UTF-8, an int as its big-endian bytes,
    no separator: ``flax_fix_rng_separator`` is off by default), whose
    first four bytes, big-endian, are ``fold_in``'s data."""
    m = hashlib.sha1()
    for x in (path, counter):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return TF.fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_normal(key, d_in: int, d_out: int) -> torch.Tensor:
    """flax's default ``Dense`` kernel ``[d_in, d_out]`` (jax's
    ``variance_scaling(1, 'fan_in', 'truncated_normal')``): ``truncated_
    normal(key, -2, 2) * (sqrt(float32(1 / d_in)) / float32(0.8796...))``,
    every step in float32 as jax's."""
    k = torch.as_tensor(key)
    var = torch.tensor(1.0 / d_in, dtype=torch.float32, device=k.device)
    std = torch.sqrt(var) / torch.tensor(_TRUNC_STD, dtype=torch.float32,
                                         device=k.device)
    return TF.truncated_normal(k, -2.0, 2.0, (d_in, d_out)) * std


class ActorCritic(nn.Module):
    """``forward(obs[..., obs_dim]) -> (logits[..., A], value[...])``: two
    separate tanh towers, built with flax's default init (``lecun_normal``
    kernels, zero biases) on torch's global generator; :meth:`from_key`
    draws it from ngx's key."""

    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        dims = (obs_dim,) + self.hidden
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"pi_{i}", nn.Linear(d_in, d_out))
            setattr(self, f"v_{i}", nn.Linear(d_in, d_out))
        self.pi_out = nn.Linear(dims[-1], n_actions)
        self.v_out = nn.Linear(dims[-1], 1)
        with torch.no_grad():
            for lin in self._linears():
                _lecun_normal_(lin.weight)
                lin.bias.zero_()

    @classmethod
    @torch.no_grad()
    def from_key(cls, key, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (64, 64)) -> "ActorCritic":
        """ngx's ``ActorCritic(n_actions, hidden).init(key, obs)``: each
        ``Dense`` ``name`` gets its kernel from :func:`lecun_normal` on
        ``flax_param_key(key, name, 1)`` and a zero bias, on ``key``'s
        device.  Against flax on the CPU the weights are within the ulp
        spread of :func:`~ngx_torch.ops.threefry.truncated_normal`
        (``PERF.md``)."""
        key = torch.as_tensor(key).to(torch.int64)
        model = cls(obs_dim, n_actions, hidden).to(key.device)
        for name, lin in model.named_children():
            d_out, d_in = lin.weight.shape
            lin.weight.copy_(lecun_normal(flax_param_key(key, name, 1),
                                          d_in, d_out).T)
            lin.bias.zero_()
        return model

    def _linears(self):
        return [m for m in self.modules() if isinstance(m, nn.Linear)]

    def pi_layers(self):
        """The policy tower as ``[(weight[out, in], bias[out]), ...]``, the
        output layer last — the layout the acting kernel takes."""
        nh = len(self.hidden)
        layers = [getattr(self, f"pi_{i}") for i in range(nh)] + [self.pi_out]
        return [(lin.weight, lin.bias) for lin in layers]

    def forward(self, obs):
        x = obs.to(torch.float32)
        a = x
        for i in range(len(self.hidden)):
            a = torch.tanh(getattr(self, f"pi_{i}")(a))
        logits = self.pi_out(a)
        v = x
        for i in range(len(self.hidden)):
            v = torch.tanh(getattr(self, f"v_{i}")(v))
        return logits, self.v_out(v)[..., 0]

    @torch.no_grad()
    def load_flax_params(self, params):
        """Copy a flax ``ActorCritic`` params tree (numpy leaves, with or
        without the top-level ``"params"`` key) into this module."""
        params = params.get("params", params)
        for name, lin in self.named_children():
            p = params[name]
            lin.weight.copy_(torch.as_tensor(np.array(p["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(np.array(p["bias"])))
        return self
