"""LidarInFront and AgentMap as spec rewrites — the port's copy of
``ngx/transforms/observations.py:14,41``.

Reference: ``gym_novel_gridworlds/observation_wrappers.py``.
"""

from __future__ import annotations

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec


def lidar_in_front(spec: EnvSpec, num_beams: int = 8) -> EnvSpec:
    """The ``LidarInFront(env, num_beams)`` wrapper
    (observation_wrappers.py:10-80): obs becomes ``num_beams`` 360° beams over
    ``items - {air, goal_item_to_craft}`` (one-hot-distance per item, range
    bounded by the interior hypotenuse, 0-fill on miss) concatenated with the
    inventory of all non-unbreakable items.  Pure data change — the beam
    tables are built in :mod:`ngx_torch.ops.rays`.
    """
    goal = spec.items[spec.goal_item] if spec.goal_item >= 0 else None
    return spec.replace(
        obs_mode=S.OBS_LIDAR_FRONT,
        base_obs_mode=(spec.base_obs_mode if spec.base_obs_mode >= 0
                       else spec.obs_mode),
        # an ObservationWrapper above re-materializes the reset obs
        # (gym ObservationWrapper.reset applies observation() last)
        reset_obs_base=False,
        lidar_num_beams=num_beams,
        # wrap-time snapshot (observation_wrappers.py:21-24)
        lidar_items=tuple(x for x in spec.items if x not in ("air", goal)),
        # max_beam_range freezes at construction (observation_wrappers.py:25)
        lidar_max_range=int(np.sqrt(2 * (spec.map_size - 2) ** 2)),
        novelty_tag=spec.novelty_tag + f"|lidar{num_beams}",
    )


def agent_map(spec: EnvSpec) -> EnvSpec:
    """The ``AgentMap(env)`` wrapper (observation_wrappers.py:83-129): obs
    becomes an 11×11 zero-padded window centred on the agent (the reference's
    ``agent_view_size`` is 5 but ``get_agentView`` slices ``extend*2+1`` = 11 —
    quirk preserved), plus facing id and inventory."""
    return spec.replace(
        obs_mode=S.OBS_AGENT_MAP,
        base_obs_mode=(spec.base_obs_mode if spec.base_obs_mode >= 0
                       else spec.obs_mode),
        reset_obs_base=False,
        novelty_tag=spec.novelty_tag + "|agentmap",
    )
