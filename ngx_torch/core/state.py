"""EnvState — the dynamic environment state as a dataclass of batched tensors.

The port's counterpart of ``ngx/core/state.py:17-43``: every leaf carries a
leading env axis ``[B]``.  The map is stored FLAT, row-major ``int32[B, H*W]``
(0 == air); ``last_done`` is bool.  :meth:`EnvState.from_ngx` and
:meth:`EnvState.to_numpy` convert to and from ngx's leaves (numpy), so the
tests hand the same states to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {
    "map": torch.int32, "agent": torch.int32, "facing": torch.int32,
    "inventory": torch.int32, "selected": torch.int32,
    "step_count": torch.int32, "last_action": torch.int32,
    "last_reward": torch.float32, "last_cost": torch.float32,
    "last_done": torch.bool,
}


@dataclasses.dataclass
class StepInfo:
    """Encoding of the reference ``info`` dict (pogostick_v1_env.py:359)."""

    result: torch.Tensor      # bool[B] — action succeeded
    step_cost: torch.Tensor   # float32[B]
    msg_code: torch.Tensor    # int32[B] — MSG_* constant
    msg_arg: torch.Tensor     # int32[B] — item id / recipe idx parameter


@dataclasses.dataclass
class EnvState:
    map: torch.Tensor          # int32[B, H*W], row-major; 0 == air
    agent: torch.Tensor        # int32[B, 2] (row, col)
    facing: torch.Tensor       # int32[B] — NORTH/SOUTH/WEST/EAST = 0/1/2/3
    inventory: torch.Tensor    # int32[B, I]
    selected: torch.Tensor     # int32[B] item id; -1 == nothing selected
    step_count: torch.Tensor   # int32[B]
    last_action: torch.Tensor  # int32[B]
    last_reward: torch.Tensor  # float32[B]
    last_cost: torch.Tensor    # float32[B]
    last_done: torch.Tensor    # bool[B]

    @property
    def batch(self) -> int:
        return self.map.shape[0]

    @property
    def device(self) -> torch.device:
        return self.map.device

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "EnvState":
        return EnvState(**{k: v.to(device) for k, v in self._leaves()})

    def put(self, idx, other: "EnvState") -> "EnvState":
        """A copy with the envs at ``idx`` replaced by ``other``'s."""
        out = {}
        for k, v in self._leaves():
            v = v.clone()
            v[idx] = getattr(other, k)
            out[k] = v
        return EnvState(**out)

    def to_numpy(self) -> dict:
        """ngx's leaves as numpy arrays: ``ngx.EnvState(**st.to_numpy())``."""
        return {k: v.detach().cpu().numpy() for k, v in self._leaves()}

    @classmethod
    def from_ngx(cls, st, device=None) -> "EnvState":
        """From any object with ngx's ``EnvState`` leaves (numpy or jax
        arrays, batched).  A flat or ``[B, H, W]`` map both load."""
        leaves = {}
        for k, dt in _DTYPES.items():
            a = np.array(getattr(st, k))
            if k == "map":
                a = a.reshape(a.shape[0], -1)
            leaves[k] = torch.as_tensor(a.astype(bool) if dt is torch.bool
                                        else a).to(dtype=dt, device=device)
        return cls(**leaves)

    def _leaves(self):
        return ((f.name, getattr(self, f.name))
                for f in dataclasses.fields(self))
