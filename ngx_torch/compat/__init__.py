"""Gym-classic facade over the port's batched step — the port of
``ngx/compat``.

A drop-in surface for users of the reference (gym 0.18-era 4-tuple API,
reference ``gym_novel_gridworlds/envs/*.py``): ``ngx_torch.compat.make(env_id)``
gives an object with ``reset() / step(a) -> (obs, reward, done, info) /
render() / close()``, name-keyed dict attributes (``items_id``,
``actions_id``, ``inventory_items_quantity``, ``selected_item`` …),
``inject_novelty``, and wrapper classes with the reference's names.  Every env
is a B = 1 slice of the plain batched step, on the card by default
(``device="cpu"`` for the CPU); the strings the reference carries per step
(``info['message']``, item names) are rebuilt on the host from integer codes.
"""

from .env import NGXEnv, make  # noqa: F401
from .wrappers import (AgentMap, BlockItem, LidarInFront,  # noqa: F401
                       LimitActions, SaveTrajectories, inject_novelty)
from .messages import decode_message  # noqa: F401
from . import constant  # noqa: F401
