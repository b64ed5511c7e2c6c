"""Trajectory recording — the port of ``ngx/transforms/trajectories.py``, the
reference's ``SaveTrajectories`` wrapper (wrappers.py:9-54) rebuilt for the
batched engine.

The port's states always carry a leading dimension, which the recorder
reads as time: the single-env facade's ``[1]``-batched state
(``env.get_state()``) is one step, and a stack of T states of one env
(``EnvState`` leaves ``[T, ...]``) is T steps.  Recording keeps the tensors
where they are; :meth:`TrajectoryRecorder.save` copies each chunk to the
host once and pickles ngx's list of per-step dicts, with the same keys,
types and values, so consumers of the reference's pickle keep working.
"""

from __future__ import annotations

import os
import pickle
from datetime import datetime
from typing import List

from ..core.spec import DIRECTION_NAMES
from ..core.state import to_host


class TrajectoryRecorder:
    def __init__(self, spec, save_path: str):
        self.spec = spec
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self._chunks: List = []

    def record(self, states):
        """Append an :class:`~ngx_torch.core.state.EnvState` whose leading
        dimension is time (one step per row).  Nothing is copied here."""
        self._chunks.append(states)

    def _state_dicts(self):
        sp = self.spec
        items_id = {n: i for i, n in enumerate(sp.items) if n != "air"}
        items_quantity = {sp.items[i]: int(q)
                          for i, q in zip(sp.spawn_items, sp.spawn_qty)}
        for chunk in self._chunks:
            host = to_host(chunk)          # one device-to-host copy
            for t in range(host["map"].shape[0]):
                inv = host["inventory"][t]
                yield {
                    "map_size": sp.map_size,
                    "map": host["map"][t].reshape(sp.map_size, sp.map_size),
                    "agent_location": tuple(host["agent"][t]),
                    "agent_facing_str": DIRECTION_NAMES[
                        int(host["facing"][t])],
                    "block_in_front_id": None,
                    "items_id": dict(items_id),
                    "items_quantity": dict(items_quantity),
                    "inventory_items_quantity": {
                        n: int(inv[i]) for i, n in enumerate(sp.items)
                        if n != "air"},
                    "action_str": sp.actions_id,
                    "last_action": int(host["last_action"][t]),
                    "last_done": bool(host["last_done"][t]),
                }

    def save(self) -> str:
        path = os.path.join(
            self.save_path,
            datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            + "_{env}.bin".format(env=self.spec.env_id))
        with open(path, "wb") as f:
            pickle.dump(list(self._state_dicts()), f)
        print("Trajectories saved at: ", path)
        return path
