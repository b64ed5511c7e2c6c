"""Keyboard keymaps for human play — parity with the reference's
``gym_novel_gridworlds/constant.py:1-41`` (active maps for v0–v5; modern envs
get runtime-generated maps via :func:`assign_keys`, replicating
``tests/keyboard_interface.py:17-62``) — the port's copy of
``ngx/compat/constant.py``."""

env_key = {
    "NovelGridworld-v0": {"w": 0, "a": 1, "d": 2},
    "NovelGridworld-v1": {"w": 0, "a": 1, "d": 2, "e": 3},
    "NovelGridworld-v2": {"1": 0, "2": 1},
    "NovelGridworld-v3": {"w": 0, "a": 1, "d": 2, "3": 3, "4": 4},
    "NovelGridworld-v4": {"w": 0, "a": 1, "d": 2, "z": 3},
    "NovelGridworld-v5": {"w": 0, "a": 1, "d": 2, "e": 3, "z": 4,
                          "1": 5, "2": 6, "3": 7, "4": 8},
}

_ACTION_KEYS = {"Forward": "w", "Left": "a", "Right": "d", "Break": "e",
                "Chop": "q", "Jump": "space", "Place_tree_tap": "z",
                "Extract_rubber": "x", "Extract_string": "x"}


def assign_keys(env):
    """key → action id for any env (tests/keyboard_interface.py:17-62):
    fixed keys for manipulation, digits for sorted Craft_*, free letters for
    sorted Select_*."""
    actions_id = getattr(env, "limited_actions_id", None) or env.actions_id

    if env.env_id in ("NovelGridworld-v6", "NovelGridworld-Bow-v0",
                      "NovelGridworld-Bow-v1", "NovelGridworld-Pogostick-v0",
                      "NovelGridworld-Pogostick-v1") or env.env_id not in env_key:
        keys = {}
        for action, k in _ACTION_KEYS.items():
            if action in actions_id:
                keys[k] = actions_id[action]
        count = 1
        for action in sorted(actions_id):
            if action.startswith("Craft"):
                keys[str(count)] = actions_id[action]
                count += 1
        alpha = "abcdefghijklmnopqrstuvwxyz"
        ai = 0
        for action in sorted(a for a in actions_id if a.startswith("Select")):
            while ai < len(alpha) and alpha[ai] in keys:
                ai += 1
            if ai < len(alpha):
                keys[alpha[ai]] = actions_id[action]
                ai += 1
        return keys
    return env_key[env.env_id]
