"""The reference's ``gym_novel_gridworlds/constant.py`` keymaps."""

from ..compat.constant import assign_keys, env_key  # noqa: F401
