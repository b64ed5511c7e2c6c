"""EnvState — the dynamic environment state as a dataclass of batched tensors.

The port's counterpart of ``ngx/core/state.py:17-43``: every leaf carries a
leading env axis ``[B]``.  The map is stored FLAT, row-major ``int32[B, H*W]``
(0 == air); ``last_done`` is bool.
"""

from __future__ import annotations

import dataclasses

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

    def where(self, mask, other: "EnvState") -> "EnvState":
        """Per env, this state where ``mask`` (bool[B]) holds, else
        ``other``'s."""
        out = {}
        for k, v in self._leaves():
            m = mask.reshape(mask.shape + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, v, getattr(other, k))
        return EnvState(**out)

    def take(self, idx) -> "EnvState":
        """The envs at ``idx`` (an index tensor), in its order."""
        return EnvState(**{k: v[idx] for k, v in self._leaves()})

    def _leaves(self):
        return ((f.name, getattr(self, f.name))
                for f in dataclasses.fields(self))
