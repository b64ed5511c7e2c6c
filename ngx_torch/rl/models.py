"""Policy/value network — the port of ``ngx/rl/models.py``.

The reference uses SB2's MlpPolicy (two 64-unit tanh layers) over the
LidarInFront vector (reference ``tests/train.py:122``).  The submodules keep
the flax names ``pi_{i}``, ``v_{i}``, ``pi_out`` and ``v_out``; a flax Dense
kernel ``[in, out]`` becomes a torch weight ``[out, in]`` only in
:meth:`ActorCritic.load_flax_params`.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

# flax's lecun_normal: a normal truncated at two standard deviations, with
# the standard deviation corrected for the truncation
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, generator=None):
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ActorCritic(nn.Module):
    """``forward(obs[..., obs_dim]) -> (logits[..., A], value[...])``: two
    separate tanh towers.  ``generator`` seeds flax's default init
    (``lecun_normal`` kernels, zero biases)."""

    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (64, 64), generator=None):
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
                _lecun_normal_(lin.weight, generator)
                lin.bias.zero_()

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
