"""The reference's ``gym_novel_gridworlds/observation_wrappers.py``."""

from ..compat.wrappers import AgentMap, LidarInFront  # noqa: F401
