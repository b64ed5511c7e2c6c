"""The lidar observations on tensors — the port of ``ngx/ops/rays.py``.

:func:`beam_offsets` is the numpy copy of ``rays.py:23``: the cell offsets
each beam visits, with the reference's double rounding
(observation_wrappers.py:42-56).  :func:`make_lidar` is the batched lidar of
``rays.py:47`` for the LidarInFront, legacy and v0 obs modes: one gather of
the beam cells, first hit by ``argmax``, one-hot distance per item slot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec as S

# reference direction→radian table (observation_wrappers.py:39)
_DIR_RAD = {S.NORTH: np.pi, S.SOUTH: 0.0, S.WEST: 3 * np.pi / 2, S.EAST: np.pi / 2}


def beam_offsets(num_beams: int, max_range: int, full_circle: bool) -> np.ndarray:
    """offsets[facing, beam, k, 2] — cell visited at range k+1."""
    out = np.zeros((4, num_beams, max_range, 2), dtype=np.int32)
    for f in range(4):
        rad = _DIR_RAD[f]
        if full_circle:
            angles = np.linspace(rad - np.pi, rad + np.pi, num_beams + 1)[:-1]
        else:
            angles = np.linspace(rad - np.pi / 2, rad + np.pi / 2, num_beams)
        for b, angle in enumerate(angles):
            x_ratio = np.round(np.cos(angle), 2)
            y_ratio = np.round(np.sin(angle), 2)
            for k in range(1, max_range + 1):
                out[f, b, k - 1, 0] = int(np.round(k * x_ratio))
                out[f, b, k - 1, 1] = int(np.round(k * y_ratio))
    return out


def lidar_slots(sp) -> np.ndarray:
    """int32[I]: the lidar column slot of each item id (-1: no beam column).
    Slots follow the name-sorted wrap-time item snapshot."""
    lidar_sorted = sorted(sp.lidar_items)
    slot_of_item = np.full((sp.n_items,), -1, dtype=np.int32)
    for i, name in enumerate(sp.items):
        if name in lidar_sorted:
            slot_of_item[i] = lidar_sorted.index(name)
    return slot_of_item


def inventory_keep(sp) -> list:
    """Item ids of the obs' inventory tail: name-sorted, minus unbreakables
    (observation_wrappers.py:70-80)."""
    return [i for _, i in sorted((n, i) for i, n in enumerate(sp.items))
            if not sp.unbreakable[i]]


def make_lidar(sp):
    """``lidar(map[B, HW], agent[B, 2], facing[B]) -> int32[B, NB*slots]``
    for the three lidar obs modes (``rays.py:47-93``):

    * ``OBS_LIDAR_FRONT``: 360°, item slots over the wrap-time
      ``lidar_items``, range ``lidar_max_range``, 0 on a miss;
    * ``OBS_LIDAR_INV`` (v1-v5, novel_gridworld_v1_env.py:139-175): the same
      beams over the legacy lidar item subset;
    * ``OBS_LIDAR_V0`` (novel_gridworld_v0_env.py:136-173): 5 beams over
      180° with the endpoints kept, one slot per item id 1..I-1, and the
      construction-time ``lidar_max_range`` as the fill of every slot the
      beam did not hit.  The reference marches until it hits; the wall ring
      bounds that within the map diameter, so 2·H probes suffice."""
    H = sp.map_size
    if sp.obs_mode == S.OBS_LIDAR_V0:
        table_np = beam_offsets(sp.lidar_num_beams, 2 * H, full_circle=False)
        slots_np = np.arange(sp.n_items, dtype=np.int32) - 1
        n_slots, fill = sp.n_items - 1, sp.lidar_max_range
    elif sp.obs_mode in (S.OBS_LIDAR_FRONT, S.OBS_LIDAR_INV):
        table_np = beam_offsets(sp.lidar_num_beams, sp.lidar_max_range,
                                full_circle=True)
        slots_np = lidar_slots(sp)
        n_slots, fill = len(sp.lidar_items), 0
    else:
        raise ValueError(f"obs mode {sp.obs_mode} has no lidar")
    on_device = {}   # the tables per device, copied there once

    def lidar(m, agent, facing):
        dev = m.device
        if str(dev) not in on_device:
            on_device[str(dev)] = tuple(
                torch.as_tensor(a, dtype=torch.int64).to(dev)
                for a in (table_np, slots_np))
        table, slots = on_device[str(dev)]
        B = m.shape[0]
        # ngx's gather wraps a negative facing once and clamps the rest
        # into 0-3 (ngx/ops/rays.py:100); torch wraps a negative index the
        # same way
        off = table[facing.long().clamp(-4, 3)]          # [B, NB, K, 2]
        rr = (agent[:, 0, None, None].long() + off[..., 0]).clamp(0, H - 1)
        cc = (agent[:, 1, None, None].long() + off[..., 1]).clamp(0, H - 1)
        vals = m.gather(1, (rr * H + cc).reshape(B, -1)).reshape(rr.shape)
        hit = vals != 0
        first = torch.argmax(hit.to(torch.int32), dim=2)  # first hit index
        has = hit.any(dim=2)
        dist = (first + 1).to(torch.int32)
        hv = vals.gather(2, first[..., None])[..., 0].long()
        slot = slots[hv]                                  # [B, NB]
        cols = torch.arange(n_slots, device=dev)
        sig = torch.where(has[..., None] & (slot[..., None] == cols)
                          & (slot[..., None] >= 0),
                          dist[..., None], torch.full((), fill,
                                                      dtype=torch.int32,
                                                      device=dev))
        return sig.reshape(B, -1)

    lidar.n_slots = n_slots
    lidar.num_beams = sp.lidar_num_beams
    return lidar


# ngx's name for make_lidar (``ngx/ops/rays.py:47``); ngx's lidar takes one
# env, this one the batch
