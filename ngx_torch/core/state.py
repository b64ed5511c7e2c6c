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


_M32 = 0xFFFFFFFF


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's low 32 bits as int32 (two's complement)."""
    x = x & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def make_state_packers(spec):
    """``(pack, unpack, n_words)``: lossless bit-packing of a batched
    :class:`EnvState` into ``int32[B, n_words]``, ngx's word layout bit for
    bit (``ngx/core/state.py:88-171``).  Per env:

    * map: 6 cells x 5 bits a word (item ids < 32), ``ceil(H*W / 6)``
      words;
    * inventory: 2 counts x 15 bits a word, ``ceil(I / 2)`` words — with
      ngx's missing width guard: a count of 32,768 or more spills into its
      neighbour's bits and ``unpack`` keeps 15 bits of each (ngx's
      behaviour, reproduced, not repaired);
    * one scalar word: agent row and column (5 + 5 bits), facing (2),
      ``selected + 1`` (6), ``last_action`` (6), ``last_done`` (1);
    * ``step_count``; ``last_reward`` and ``last_cost`` bit-cast.

    ``unpack(pack(s)) == s`` exactly while every count stays below 32,768.
    On Pogostick-v1 that is 26 words an env against 118 unpacked.  The
    rollout kernel writes its final state in this layout
    (``ops/rollout.py``, ``packed=True``)."""
    H = spec.map_size
    HW = H * H
    I = spec.n_items
    assert I <= 31, "5-bit map cells need item ids < 32"
    assert H <= 32, "5-bit agent coordinates need map_size <= 32"
    assert spec.n_actions <= 63, "6-bit last_action needs < 64 actions"
    MAP_W = -(-HW // 6)
    INV_W = -(-I // 2)
    n_words = MAP_W + INV_W + 4     # + scalars, step_count, 2 floats
    shifts5 = torch.arange(6, dtype=torch.int64) * 5

    def pack(st: EnvState) -> torch.Tensor:
        B, dev = st.batch, st.device
        sh = shifts5.to(dev)
        m = torch.zeros((B, MAP_W * 6), dtype=torch.int64, device=dev)
        m[:, :HW] = st.map
        mw = (m.reshape(B, MAP_W, 6) << sh).sum(-1)
        inv = torch.zeros((B, INV_W * 2), dtype=torch.int64, device=dev)
        inv[:, :I] = st.inventory
        inv = inv.reshape(B, INV_W, 2)
        iw = inv[:, :, 0] | (inv[:, :, 1] << 15)
        a = st.agent.to(torch.int64)
        sc = (a[:, 0] | (a[:, 1] << 5) | (st.facing.to(torch.int64) << 10)
              | ((st.selected.to(torch.int64) + 1) << 12)
              | (st.last_action.to(torch.int64) << 18)
              | (st.last_done.to(torch.int64) << 24))
        return torch.cat(
            [_as_i32(mw), _as_i32(iw), _as_i32(sc)[:, None],
             st.step_count.to(torch.int32)[:, None],
             st.last_reward.contiguous().view(torch.int32)[:, None],
             st.last_cost.contiguous().view(torch.int32)[:, None]], dim=1)

    def unpack(p: torch.Tensor) -> EnvState:
        B = p.shape[0]
        mw = p[:, :MAP_W]
        m = ((mw[:, :, None] >> shifts5.to(p.device).to(torch.int32)) & 31
             ).reshape(B, MAP_W * 6)[:, :HW]
        iw = p[:, MAP_W:MAP_W + INV_W]
        inv = torch.stack([iw & 0x7FFF, (iw >> 15) & 0x7FFF],
                          dim=-1).reshape(B, INV_W * 2)[:, :I]
        sc = p[:, MAP_W + INV_W]
        return EnvState(
            map=m.contiguous(),
            agent=torch.stack([sc & 31, (sc >> 5) & 31], dim=-1),
            facing=(sc >> 10) & 3,
            inventory=inv.contiguous(),
            selected=((sc >> 12) & 63) - 1,
            step_count=p[:, MAP_W + INV_W + 1].clone(),
            last_action=(sc >> 18) & 63,
            last_reward=p[:, MAP_W + INV_W + 2].contiguous().view(
                torch.float32),
            last_cost=p[:, MAP_W + INV_W + 3].contiguous().view(
                torch.float32),
            last_done=((sc >> 24) & 1) != 0,
        )

    return pack, unpack, n_words
