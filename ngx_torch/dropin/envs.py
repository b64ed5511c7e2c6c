"""The 11 reference env classes as facade constructors — the port of the
JAX alias's ``gym_novel_gridworlds/envs/__init__.py``.

Each class name is the reference's (``envs/__init__.py:1-13``); calling it
returns a :class:`ngx_torch.compat.NGXEnv` with the reference's attribute
and method surface, restore-chaining through ``env=``
(``pogostick_v1_env.py:26``: ``__init__(self, env=None)``; v0/v1 take no
arguments, and the extra keywords here are an accepted superset).  The env
runs on the device :func:`ngx_torch.dropin.install` set — the card unless
it was given another — or on ``device=`` when a call passes one.
"""

from ..compat import make as _compat_make

CLASS_NAMES = {
    "NovelGridworld-v0": "NovelGridworldV0Env",
    "NovelGridworld-v1": "NovelGridworldV1Env",
    "NovelGridworld-v2": "NovelGridworldV2Env",
    "NovelGridworld-v3": "NovelGridworldV3Env",
    "NovelGridworld-v4": "NovelGridworldV4Env",
    "NovelGridworld-v5": "NovelGridworldV5Env",
    "NovelGridworld-v6": "NovelGridworldV6Env",
    "NovelGridworld-Bow-v0": "BowV0Env",
    "NovelGridworld-Bow-v1": "BowV1Env",
    "NovelGridworld-Pogostick-v0": "PogostickV0Env",
    "NovelGridworld-Pogostick-v1": "PogostickV1Env",
}

# the device the constructors and make() default to; install() sets it
DEFAULT = {"device": "cuda"}


def make(env_id, env=None, map_size=10, **kw):
    """``gym.make``-alike over the 11 presets (reference
    ``__init__.py:7-60``), on the installed device unless ``device=`` is
    given; it raises where that device is the card and there is none."""
    kw.setdefault("device", DEFAULT["device"])
    return _compat_make(env_id, env=env, map_size=map_size, **kw)


def _env_class(env_id):
    class _Env:
        def __new__(cls, env=None, map_size=10, **kw):
            return make(env_id, env=env, map_size=map_size, **kw)

    _Env.__name__ = _Env.__qualname__ = CLASS_NAMES[env_id]
    _Env.__module__ = __name__
    _Env.__doc__ = f"Facade constructor for {env_id} (returns NGXEnv)."
    return _Env


NovelGridworldV0Env = _env_class("NovelGridworld-v0")
NovelGridworldV1Env = _env_class("NovelGridworld-v1")
NovelGridworldV2Env = _env_class("NovelGridworld-v2")
NovelGridworldV3Env = _env_class("NovelGridworld-v3")
NovelGridworldV4Env = _env_class("NovelGridworld-v4")
NovelGridworldV5Env = _env_class("NovelGridworld-v5")
NovelGridworldV6Env = _env_class("NovelGridworld-v6")
BowV0Env = _env_class("NovelGridworld-Bow-v0")
BowV1Env = _env_class("NovelGridworld-Bow-v1")
PogostickV0Env = _env_class("NovelGridworld-Pogostick-v0")
PogostickV1Env = _env_class("NovelGridworld-Pogostick-v1")
