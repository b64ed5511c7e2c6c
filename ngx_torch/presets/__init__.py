"""Registry of the environment ids the port supports → spec builders
(reference gym_novel_gridworlds/__init__.py:7-60)."""

from . import modern

SPEC_BUILDERS = {
    "NovelGridworld-v6": modern.novelgridworld_v6,
    "NovelGridworld-Bow-v0": modern.bow_v0,
    "NovelGridworld-Bow-v1": modern.bow_v1,
    "NovelGridworld-Pogostick-v1": modern.pogostick_v1,
}

# reference ids whose presets (legacy template, Pogostick-v0's tap reset) are
# not ported yet
NOT_PORTED = ("NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
              "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
              "NovelGridworld-Pogostick-v0")


def make_spec(env_id: str, map_size: int = 10):
    if env_id in NOT_PORTED:
        raise NotImplementedError(
            f"{env_id} is not ported to ngx_torch yet (ROADMAP.md, Queue 1)")
    if env_id not in SPEC_BUILDERS:
        raise KeyError(f"Unknown env id {env_id!r}; known: {sorted(SPEC_BUILDERS)}")
    return SPEC_BUILDERS[env_id](map_size=map_size)
