"""Spec rewrites (numpy) — the port's copy of ``ngx.transforms``' observation
and action rewrites."""

from .actions import limit_actions, remap_actions  # noqa: F401
from .observations import agent_map, lidar_in_front  # noqa: F401
