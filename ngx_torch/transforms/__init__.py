"""Spec rewrites (numpy) — the port's copy of ``ngx.transforms``' observation
rewrite."""

from .observations import lidar_in_front  # noqa: F401
