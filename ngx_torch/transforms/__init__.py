"""Spec rewrites (numpy) — the port's copy of ``ngx.transforms``' observation
rewrites."""

from .observations import agent_map, lidar_in_front  # noqa: F401
