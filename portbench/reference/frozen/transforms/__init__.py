"""Frozen copy of the port's ``transforms`` package: the LidarInFront
observation the configurations use."""

from .observations import lidar_in_front  # noqa: F401
