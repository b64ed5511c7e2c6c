"""The port's ``gym_novel_gridworlds`` drop-in surface (ngx_torch/dropin)
against ngx's alias package of that name, case for case with
tests/test_dropin_alias.py, on the CPU.

Each test holds ngx's alias (the repository's ``gym_novel_gridworlds``)
and the port's, installed under the same name by ``install(device="cpu")``,
and drives both the same way: ``numpy.random`` seeded alike before each
construction and reset, the same actions, and obs (value and dtype),
reward, done and info compared step for step.  The module table is purged
of ``gym_novel_gridworlds*`` before and after each test, as that file's
fixture does: tests/reference_loader.py loads the mounted reference under
the same name."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ngx_torch.dropin as dropin
from ngx_torch.compat import NGXEnv

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SHIM = str(pathlib.Path(__file__).parent / "_gym_shim")
POGO = "NovelGridworld-Pogostick-v1"


def _purge(prefixes=("gym_novel_gridworlds",)):
    for n in [n for n in sys.modules if n.split(".")[0] in prefixes]:
        del sys.modules[n]


@pytest.fixture()
def alias():
    """``(J, P)``: ngx's alias package and the port's, the port installed
    as ``gym_novel_gridworlds`` on the CPU."""
    _purge()
    import gym_novel_gridworlds as J
    assert J.__file__.startswith(str(REPO / "gym_novel_gridworlds")), \
        J.__file__
    P = dropin.install(device="cpu")
    import gym_novel_gridworlds
    assert gym_novel_gridworlds is P is dropin
    yield J, P
    dropin.uninstall()
    assert sys.modules["gym_novel_gridworlds"] is J
    _purge()


def same(a, b):
    """Equal values of equal types; numpy arrays also by dtype and shape."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in b))
    if isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and bool((a == b).all()))
    return type(a) is type(b) and a == b


def play(make_env, seed, steps, episodes=1):
    """``numpy.random`` seeded with ``seed``, ``make_env()``, then
    ``episodes`` episodes of at most ``steps`` random actions (their own
    ``RandomState``), each reset seeded: the trace of every reset and
    step."""
    np.random.seed(seed)
    env = make_env()
    rng = np.random.RandomState(seed + 1)
    trace = []
    for ep in range(episodes):
        np.random.seed(seed * 10 + ep)
        trace.append(env.reset())
        for _ in range(steps):
            out = env.step(int(rng.randint(env.action_space.n)))
            trace.append(out)
            if out[2]:
                break
    return trace, env


def assert_same_play(make_j, make_p, seed, steps, episodes=1):
    want, env_j = play(make_j, seed, steps, episodes)
    got, env_p = play(make_p, seed, steps, episodes)
    assert env_p.device.type == "cpu"     # a port env, on the CPU
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert same(g, w), (t, g, w)
    return got, env_j, env_p


def test_package_imports_reference_surface(alias):
    """Every public name of ngx's alias and of its five submodules is in
    the port's, and the module table maps the submodules to the port's."""
    J, P = alias
    assert P.ENV_IDS == J.ENV_IDS and len(P.ENV_IDS) == 11
    for name, mod_j in [("", J)] + [(f".{s}", getattr(J, s))
                                   for s in P.SUBMODULES]:
        mod_p = sys.modules[f"gym_novel_gridworlds{name}"]
        assert mod_p.__name__ == f"ngx_torch.dropin{name}"
        public = {n for n in vars(mod_j) if not n.startswith("_")}
        assert public <= set(vars(mod_p)), (name, public - set(vars(mod_p)))
    assert P.constant.env_key == J.constant.env_key
    assert set(J.novelty_wrappers.__all__) == set(P.novelty_wrappers.__all__)


@pytest.mark.parametrize("env_id", sorted(dropin.envs.CLASS_NAMES))
def test_env_classes_construct_and_step(alias, env_id):
    """Each of the 11 classes from ``gym_novel_gridworlds.envs``: two
    random episodes equal to ngx's alias's, and the class names equal."""
    J, _ = alias
    from gym_novel_gridworlds import envs

    name = dropin.envs.CLASS_NAMES[env_id]
    cls_j, cls_p = getattr(J.envs, name), getattr(envs, name)
    assert cls_p.__name__ == cls_j.__name__ == name
    trace, _, env = assert_same_play(cls_j, cls_p, 7, 40, episodes=2)
    assert env.env_id == env_id
    obs = trace[0]
    if env_id == POGO:
        assert set(obs) == {"map", "agent_location", "agent_facing_id",
                            "inventory_items_quantity"}
        assert set(trace[1][3]) == {"result", "step_cost", "message"}
    elif env_id == "NovelGridworld-v1":
        assert obs.ndim == 1
    elif env_id == "NovelGridworld-Bow-v0":
        assert env.goal_item_to_craft == "bow"


def test_restore_chaining_ctor(alias):
    J, _ = alias
    from gym_novel_gridworlds.envs import (NovelGridworldV2Env,
                                           NovelGridworldV3Env)

    out = {}
    for name, v2, v3 in (("ngx", J.envs.NovelGridworldV2Env,
                          J.envs.NovelGridworldV3Env),
                         ("port", NovelGridworldV2Env, NovelGridworldV3Env)):
        np.random.seed(11)
        e2 = v2()
        trace = [e2.reset()]
        for a in (0, 1, 0):
            trace.append(e2.step(a))
        e3 = v3(env=e2)
        trace.append(e3.reset())
        assert e3.agent_location == e2.agent_location
        assert np.array_equal(e3.map, e2.map)
        for a in range(e3.action_space.n):
            trace.append(e3.step(a))
        out[name] = trace + [e3.map, e3.inventory_items_quantity]
    assert same(out["port"], out["ngx"])


def test_wrapper_stack_reference_style(alias):
    """The reference's stack: make -> LimitActions -> LidarInFront ->
    inject_novelty (tests/random_action.py:16-42), step for step."""
    J, _ = alias
    import gym_novel_gridworlds as gnw
    from gym_novel_gridworlds.novelty_wrappers import inject_novelty
    from gym_novel_gridworlds.observation_wrappers import LidarInFront
    from gym_novel_gridworlds.wrappers import LimitActions

    def stack(pkg, limit, lidar, inject):
        env = pkg.make("NovelGridworld-Bow-v0")
        env = limit(env, {"Forward", "Left", "Right", "Break",
                          "Extract_string", "Craft_bow"})
        env = lidar(env, num_beams=8)
        return inject(env, "firewall", "easy")

    trace, _, _ = assert_same_play(
        lambda: stack(J, J.wrappers.LimitActions,
                      J.observation_wrappers.LidarInFront,
                      J.novelty_wrappers.inject_novelty),
        lambda: stack(gnw, LimitActions, LidarInFront, inject_novelty),
        3, 60, episodes=2)
    # FireWall's reset returns the base env's dict obs under a lidar
    # (novelty_wrappers.py:1146); steps return the lidar array
    assert isinstance(trace[0], dict) and "map" in trace[0]
    assert np.asarray(trace[1][0]).ndim == 1


# every class of novelty_wrappers, each with its arguments, from
# Pogostick-v1 (Bow-v1 for ExtractIncDec's increase, reachable only by
# direct construction)
NOVELTY_CLASSES = (
    ("AxeEasy", ("wooden",), POGO), ("AxeMedium", ("iron",), POGO),
    ("AxeHard", ("iron", "true"), POGO), ("AxetoBreakEasy", ("wooden",), POGO),
    ("AxetoBreakMedium", ("iron",), POGO),
    ("AxetoBreakHard", ("iron",), POGO),
    ("Fence", ("easy", "oak"), POGO),
    ("FenceRestriction", ("medium", "oak"), POGO),
    ("AddItem", ("hard", "fence"), POGO), ("Crate", ("easy",), POGO),
    ("ReplaceItem", ("medium", "tree_log", "stone"), POGO),
    ("FireWall", ("easy",), POGO), ("AddChopAction", (), POGO),
    ("AddJumpAction", (), POGO), ("BreakIncrease", ("tree_log",), POGO),
    ("ExtractIncDec", ("increase",), "NovelGridworld-Bow-v1"),
    ("BlockItem", (), POGO),
)


@pytest.mark.parametrize("name,args,env_id", NOVELTY_CLASSES,
                         ids=[c[0] for c in NOVELTY_CLASSES])
def test_novelty_classes_direct_construction(alias, name, args, env_id):
    """Each class constructed directly over a reset base env (the medium
    axes take their throwaway mirror draw, on the CPU), then 20 random
    actions: step for step ngx's alias's."""
    J, P = alias
    from gym_novel_gridworlds import novelty_wrappers as nw

    def build(pkg, cls):
        def make():
            base = pkg.make(env_id)
            base.reset()
            return cls(base, *args)
        return make

    _, env_j, env_p = assert_same_play(
        build(J, getattr(J.novelty_wrappers, name)),
        build(P, getattr(nw, name)), 5, 20)
    assert env_p.actions_id == env_j.actions_id
    assert env_p.items_id == env_j.items_id
    if name == "ExtractIncDec":
        # direct construction skips inject_novelty's asserts, which both
        # keep
        for pkg in (J, P):
            with pytest.raises(AssertionError):
                pkg.novelty_wrappers.inject_novelty(
                    pkg.make("NovelGridworld-Bow-v1"), "extractincdec",
                    "hard", "increase")


@pytest.mark.parametrize("limited", [False, True])
def test_remap_action_difficulty_function_form(alias, limited):
    """The whole table remapped with the live state kept, or with a
    LimitActions below only the limited table, in place: ngx's draws."""
    J, _ = alias
    import gym_novel_gridworlds as gnw
    from gym_novel_gridworlds.novelty_wrappers import remap_action_difficulty
    from gym_novel_gridworlds.wrappers import LimitActions

    out = {}
    for name, pkg, remap, limit in (
            ("ngx", J, J.novelty_wrappers.remap_action_difficulty,
             J.wrappers.LimitActions),
            ("port", gnw, remap_action_difficulty, LimitActions)):
        np.random.seed(9)
        env = pkg.make(POGO)
        if limited:
            env = limit(env, {"Forward", "Left", "Right", "Break"})
        env.reset()
        before = dict(env.limited_actions_id or env.actions_id)
        env2 = remap(env, "hard")
        after = dict(env2.limited_actions_id or env2.actions_id)
        assert set(after) == set(before) and after != before
        assert env2.agent_location == env.agent_location
        out[name] = [after, env2.step(0), env2.step(1)]
    assert same(out["port"], out["ngx"])


def _gym_mods():
    return [m for m in sys.modules if m == "gym" or m.startswith("gym.")]


@pytest.fixture()
def shim_gym(monkeypatch):
    """The tests' minimal gym on the path, and a module table without any
    gym or alias before and after."""
    monkeypatch.syspath_prepend(SHIM)
    for m in _gym_mods():
        sys.modules.pop(m)
    _purge()
    yield
    dropin.uninstall()
    for m in _gym_mods():
        sys.modules.pop(m)
    _purge()


def test_gym_make_after_install_is_the_port(shim_gym):
    """ngx's alias imported first registers the 11 ids to its classes;
    ``install()`` replaces them, so ``gym.make`` returns a port env, step
    for step ngx's; ``uninstall()`` puts back ngx's modules and
    registrations."""
    import gym
    import gym_novel_gridworlds as J
    assert J.GYM_REGISTERED and not dropin.GYM_REGISTERED
    env_id = "NovelGridworld-Bow-v0"
    ngx_make = gym.make
    want, env_j = play(lambda: ngx_make(env_id), 1, 30)
    assert not isinstance(env_j, NGXEnv)
    P = dropin.install(device="cpu")
    import gym_novel_gridworlds
    assert gym_novel_gridworlds is P and P.GYM_REGISTERED
    for i in P.ENV_IDS:
        assert gym._REGISTRY[i][0] == \
            f"ngx_torch.dropin.envs:{dropin.envs.CLASS_NAMES[i]}"
    got, env_p = play(lambda: gym.make(env_id), 1, 30)
    assert isinstance(env_p, NGXEnv) and env_p.device.type == "cpu"
    assert same(got, want)
    dropin.uninstall()
    import gym_novel_gridworlds as back
    assert back is J and not dropin.GYM_REGISTERED
    assert gym._REGISTRY[env_id][0] == "gym_novel_gridworlds.envs:BowV0Env"
    np.random.seed(1)
    assert not isinstance(gym.make(env_id), NGXEnv)


def test_gym_make_without_a_prior_alias(shim_gym):
    """With nothing registered before, ``install()`` registers the 11 ids
    and ``gym.make`` builds each; ``uninstall()`` leaves none registered
    and no alias module in the table."""
    import gym
    P = dropin.install(device="cpu")
    import gym_novel_gridworlds
    assert gym_novel_gridworlds is P and P.GYM_REGISTERED
    for env_id in P.ENV_IDS:
        np.random.seed(2)
        env = gym.make(env_id)
        assert isinstance(env, NGXEnv) and env.env_id == env_id
        env.reset()
    dropin.uninstall()
    assert not any(i in gym._REGISTRY for i in P.ENV_IDS)
    assert "gym_novel_gridworlds" not in sys.modules


def test_entry_points_default_to_the_card():
    """Without ``install(device=...)`` the constructors and ``make`` run on
    the card, and ``install()`` checks its device: where there is no card
    they raise, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dropin.make(POGO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dropin.envs.PogostickV1Env()
    _purge()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dropin.install()
    assert "gym_novel_gridworlds" not in sys.modules
    assert dropin.make(POGO, device="cpu").device.type == "cpu"


def test_dropin_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'gym'):\n"
            "    sys.modules[m] = None\n"
            "import ngx_torch.dropin as d\n"
            "assert 'ngx' not in sys.modules\n"
            "assert 'gym_novel_gridworlds' not in sys.modules\n"
            "d.install(device='cpu')\n"
            "import gym_novel_gridworlds as g\n"
            "from gym_novel_gridworlds.envs import PogostickV1Env\n"
            "assert g is d and not g.GYM_REGISTERED\n"
            "PogostickV1Env().reset()\n"
            "assert 'ngx' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
