"""The ``gym_novel_gridworlds`` drop-in surface on the port — the
counterpart of the JAX alias package of that name at the repository root.

Code written for the reference does ``import gym_novel_gridworlds`` and then
``gym.make('NovelGridworld-*')`` or constructs env classes and wrappers
directly (reference ``gym_novel_gridworlds/__init__.py:1-60``).  This
package has that surface over :mod:`ngx_torch.compat`, under its own name:

* the 11 env classes in :mod:`ngx_torch.dropin.envs`, and :func:`make`;
* ``constant`` (``env_key``, ``assign_keys``), ``wrappers``,
  ``observation_wrappers`` and ``novelty_wrappers``, with the reference's
  class names and constructor signatures, imported with the package as the
  reference's are.

:func:`install` puts it under the reference's name: ``sys.modules
["gym_novel_gridworlds"]`` and its five submodules become this package's,
the constructors run on the device it is given (the card by default), and
when a gym can be imported the 11 ids are registered with it to this
package's classes, replacing whatever entry point held them (the JAX
alias's too).  :func:`uninstall` puts back the modules and registrations
that were there before.  Without :func:`install` nothing is registered and
no module table changes.
"""

import sys

from . import constant  # noqa: F401
from . import envs  # noqa: F401
from . import novelty_wrappers  # noqa: F401
from . import observation_wrappers  # noqa: F401
from . import wrappers  # noqa: F401
from .envs import make  # noqa: F401

ENV_IDS = tuple(envs.CLASS_NAMES)
NAME = "gym_novel_gridworlds"
SUBMODULES = ("constant", "envs", "novelty_wrappers", "observation_wrappers",
              "wrappers")

# set by install(): True when a gym took the 11 registrations
GYM_REGISTERED = False
# what install() replaced: the module table's entries under NAME, and the
# gym registry's entries of the 11 ids (None: the id was not registered)
_saved = None


def install(device="cuda"):
    """Make ``import gym_novel_gridworlds`` (and its five submodules) give
    this package, its constructors default to ``device``, and register the
    11 ids with gym where a gym imports.  ``device`` is checked here: the
    card raises where there is none.  Calling it again changes the device
    and registers again; :func:`uninstall` still restores what the first
    call found."""
    global GYM_REGISTERED, _saved
    from ..ops.tables import resolve_device

    envs.DEFAULT["device"] = str(resolve_device(device))
    if _saved is None:
        _saved = {"modules": {n: m for n, m in sys.modules.items()
                              if n.split(".")[0] == NAME},
                  "gym": None}
    for n in list(sys.modules):
        if n.split(".")[0] == NAME:
            del sys.modules[n]
    sys.modules[NAME] = sys.modules[__name__]
    for sub in SUBMODULES:
        sys.modules[f"{NAME}.{sub}"] = sys.modules[f"{__name__}.{sub}"]
    GYM_REGISTERED = _register_with_gym()
    return sys.modules[__name__]


def uninstall():
    """Undo :func:`install`: the module table's ``gym_novel_gridworlds``
    entries and gym's registrations of the 11 ids are what they were before
    it, and the constructors default to the card again."""
    global GYM_REGISTERED, _saved
    if _saved is None:
        return
    for n in list(sys.modules):
        if n.split(".")[0] == NAME:
            del sys.modules[n]
    sys.modules.update(_saved["modules"])
    table = _gym_table()
    if _saved["gym"] is not None and table is not None:
        for env_id, entry in _saved["gym"].items():
            if entry is None:
                table.pop(env_id, None)
            else:
                table[env_id] = entry
    envs.DEFAULT["device"] = "cuda"
    GYM_REGISTERED = False
    _saved = None


def _gym_table():
    """gym's registry as a dict of id -> registration, or None where no gym
    imports: ``registry.env_specs`` (gym 0.18-0.21), ``registry`` (a dict
    from gym 0.26), or a minimal gym's module-level ``_REGISTRY`` dict (the
    stand-in the tests import)."""
    try:
        import gym
        from gym.envs import registration
    except ImportError:
        return None
    reg = getattr(registration, "registry", None)
    if reg is not None:
        return getattr(reg, "env_specs", reg)
    return getattr(gym, "_REGISTRY", None)


def _entry_point(registration):
    if isinstance(registration, tuple):          # the minimal gym's
        return registration[0]
    return getattr(registration, "entry_point", None)


def _register_with_gym() -> bool:
    """Register the 11 ids (reference ``__init__.py:7-60``) to this
    package's classes when a gym imports; an id already registered to
    another entry point is replaced, and where gym's registry cannot be
    read the registration must take or this raises — never leaving an id
    silently on another package."""
    try:
        from gym import error as gym_error
        from gym.envs.registration import register
    except ImportError:
        return False
    table = _gym_table()
    if _saved["gym"] is None:
        _saved["gym"] = {env_id: (None if table is None
                                  else table.get(env_id))
                         for env_id in ENV_IDS}
    for env_id, cls in envs.CLASS_NAMES.items():
        entry = f"{envs.__name__}:{cls}"
        if table is not None:
            table.pop(env_id, None)
        try:
            register(id=env_id, entry_point=entry)
        except gym_error.Error as e:       # gym 0.18-0.21: a duplicate id
            raise RuntimeError(
                f"gym refused to register {env_id} to {entry}: {e}") from e
        if table is not None and _entry_point(table.get(env_id)) != entry:
            raise RuntimeError(f"gym's registry holds {env_id} to "
                               f"{_entry_point(table.get(env_id))!r}, not "
                               f"{entry}")
    return True
