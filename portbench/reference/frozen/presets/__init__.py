"""Registry of the 11 reference environment ids → spec makers
(reference gym_novel_gridworlds/__init__.py:7-60)."""

from . import legacy, modern

SPEC_MAKERS = {
    "NovelGridworld-v0": legacy.novelgridworld_v0,
    "NovelGridworld-v1": legacy.novelgridworld_v1,
    "NovelGridworld-v2": legacy.novelgridworld_v2,
    "NovelGridworld-v3": legacy.novelgridworld_v3,
    "NovelGridworld-v4": legacy.novelgridworld_v4,
    "NovelGridworld-v5": legacy.novelgridworld_v5,
    "NovelGridworld-v6": modern.novelgridworld_v6,
    "NovelGridworld-Bow-v0": modern.bow_v0,
    "NovelGridworld-Bow-v1": modern.bow_v1,
    "NovelGridworld-Pogostick-v0": modern.pogostick_v0,
    "NovelGridworld-Pogostick-v1": modern.pogostick_v1,
}


def make_spec(env_id: str, map_size: int = 10):
    if env_id not in SPEC_MAKERS:
        raise KeyError(f"Unknown env id {env_id!r}; known: {sorted(SPEC_MAKERS)}")
    return SPEC_MAKERS[env_id](map_size=map_size)
