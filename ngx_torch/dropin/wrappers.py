"""The reference's ``gym_novel_gridworlds/wrappers.py``."""

from ..compat.wrappers import LimitActions, SaveTrajectories  # noqa: F401
