"""The port's single-env facade (ngx_torch/compat) and its mirror reset
(ngx_torch/core/mirror.py) against ngx's on the CPU.

Both facades see the same ``np.random`` seeds and the same random actions
(numpy, seeded): the mirror reset must give ngx's start state bit for bit,
and every step the same obs (values and dtype), reward, done, info and
host views.  The 'native' reset is ngx's on ngx's keys: the same seed gives
ngx's states, reset for reset."""

import os
import pickle
import random

import numpy as np
import pytest
import torch

import ngx
import ngx.compat as C
from ngx.core.mirror import mirror_reset as mirror_j
import ngx_torch as nt
import ngx_torch.compat as TC
from ngx_torch.core.mirror import mirror_reset as mirror_t

torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
PRESETS = [
    "NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
    "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
    "NovelGridworld-v6", "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0", POGO,
]
FIELDS = ("map", "agent", "facing", "inventory", "selected", "step_count",
          "last_action", "last_reward", "last_cost", "last_done")
LIMITED = {"Forward", "Left", "Right", "Break", "Craft_plank",
           "Craft_stick", "Select_tree_log"}


def assert_state_equal(ts, js):
    """A port ``[1]`` state against an ngx (unbatched) state, field by
    field and dtype by dtype."""
    for k in FIELDS:
        t = getattr(ts, k).numpy()[0]
        j = np.asarray(getattr(js, k))
        assert t.dtype == j.dtype, k
        np.testing.assert_array_equal(t, j, err_msg=k)


def assert_obs_equal(o, ref, where):
    if isinstance(ref, dict):
        assert list(o) == list(ref), where
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert o[k].dtype == v.dtype, (where, k)
                np.testing.assert_array_equal(o[k], v, err_msg=f"{where} {k}")
            else:
                assert type(o[k]) is type(v) and o[k] == v, (where, k)
    else:
        assert o.dtype == ref.dtype, where
        np.testing.assert_array_equal(o, ref, err_msg=str(where))


def space_shape(space):
    if hasattr(space, "spaces"):
        return {k: v.shape for k, v in space.spaces.items()}
    return space.shape


def views(env):
    """Every host view ngx's facade exposes that the tests compare."""
    return dict(map=env.map.tolist(), agent_location=env.agent_location,
                agent_facing_str=env.agent_facing_str,
                inventory_items_quantity=env.inventory_items_quantity,
                selected_item=env.selected_item,
                block_in_front_str=env.block_in_front_str,
                step_count=env.step_count, last_done=env.last_done,
                last_reward=env.last_reward, last_action=env.last_action,
                n=env.action_space.n)


def play_both(ref, env, seed, episodes=2, cap=100):
    """``episodes`` random-action episodes on both facades, every step
    compared."""
    assert env.action_space.n == ref.action_space.n
    rng = np.random.RandomState(seed + 1)
    for ep in range(episodes):
        np.random.seed(seed * 10 + ep)
        o_j = ref.reset()
        np.random.seed(seed * 10 + ep)
        o_t = env.reset()
        assert_obs_equal(o_t, o_j, (ep, "reset"))
        assert views(env) == views(ref)
        if ep == 0:
            assert space_shape(env.observation_space) == \
                space_shape(ref.observation_space)
        for t in range(cap):
            a = int(rng.randint(ref.action_space.n))
            o_j, r_j, d_j, i_j = ref.step(a)
            o_t, r_t, d_t, i_t = env.step(a)
            assert_obs_equal(o_t, o_j, (ep, t))
            assert (r_t, d_t, i_t) == (r_j, d_j, i_j), (ep, t)
            assert views(env) == views(ref), (ep, t)
            if d_j:
                break


# ---- the mirror reset -------------------------------------------------------

MIRROR_CASES = [(e, s) for e in PRESETS for s in (0, 7, 1234)]


@pytest.mark.parametrize("env_id,seed", MIRROR_CASES)
def test_mirror_reset_matches_ngx(env_id, seed):
    np.random.seed(seed)
    js = mirror_j(ngx.make_spec(env_id))
    after_j = np.random.randint(2 ** 30)
    np.random.seed(seed)
    ts = mirror_t(nt.make_spec(env_id), device="cpu")
    after_t = np.random.randint(2 ** 30)
    assert_state_equal(ts, js)
    assert after_t == after_j       # the same number of draws


@pytest.mark.parametrize("novelty", [("fence", "medium", "oak"),
                                     ("axe", "medium", "wooden"),
                                     ("addjump", "hard", "")])
def test_mirror_reset_under_novelty_matches_ngx(novelty):
    """Through ``compat.inject_novelty``: axe medium draws a throwaway
    mirror reset at construction (novelty_wrappers.py:129), then the env's
    own reset."""
    draws = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        np.random.seed(3)
        env = M.inject_novelty(M.make(POGO, **kw), *novelty)
        obs = env.reset()
        draws.append((env, obs, np.random.randint(2 ** 30)))
    (ref, o_j, after_j), (env, o_t, after_t) = draws
    assert_state_equal(env._state, ref._state)
    assert_obs_equal(o_t, o_j, "reset")
    assert after_t == after_j       # the throwaway draw replayed


# ---- the facade, step by step ------------------------------------------------

def _stack(M, kw):
    env = M.inject_novelty(M.make(POGO, **kw), "axe", "medium", "wooden")
    return M.inject_novelty(env, "fence", "easy", "oak")


FACADES = {**{e: (lambda M, kw, e=e: M.make(e, **kw)) for e in PRESETS},
           "lidar": lambda M, kw: M.LidarInFront(M.make(POGO, **kw)),
           "agentmap": lambda M, kw: M.AgentMap(M.make(POGO, **kw)),
           "limit": lambda M, kw: M.LimitActions(M.make(POGO, **kw), LIMITED),
           "axe-medium+fence-easy": _stack}


@pytest.mark.parametrize("case", list(FACADES))
def test_facade_matches_ngx(case):
    np.random.seed(0)
    ref = FACADES[case](C, {})
    np.random.seed(0)
    env = FACADES[case](TC, {"device": "cpu"})
    play_both(ref, env, seed=5)


def test_restore_chain_v2_to_v5_matches_ngx(capsys):
    """The enjoy.py v5 curriculum path (enjoy.py:58-100): each env restores
    the previous env's terminal state, items mapped by name."""
    chain = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
             "NovelGridworld-v5"]
    ref, env = C.make(chain[0]), TC.make(chain[0], device="cpu")
    np.random.seed(0)
    ref.reset()
    np.random.seed(0)
    env.reset()
    rng = np.random.RandomState(1)
    for _ in range(20):
        a = int(rng.randint(ref.action_space.n))
        assert env.step(a)[1:] == ref.step(a)[1:]
    for nxt in chain[1:]:
        ref, env = C.make(nxt, env=ref), TC.make(nxt, env=env, device="cpu")
        np.random.seed(42)
        o_j = ref.reset()
        np.random.seed(42)
        o_t = env.reset()
        assert_obs_equal(o_t, o_j, nxt)
        assert_state_equal(env._state, ref._state)
        rng2 = np.random.RandomState(7)
        for t in range(15):
            a = int(rng2.randint(env.action_space.n))
            o_j, *rest_j = ref.step(a)
            o_t, *rest_t = env.step(a)
            assert_obs_equal(o_t, o_j, (nxt, t))
            assert rest_t == rest_j, (nxt, t)
    assert capsys.readouterr().out.count("RESTORING LAST ENV ...") == 6


# ---- the mutation hooks ------------------------------------------------------

def test_mutation_hooks_match_ngx():
    """block_items, add_fence_around, set_lasts, set_agent_location /
    facing and add_new_items (pogostick_v1_env.py:192-198, :495-536): the
    same maps and views, then the same steps."""
    ref, env = C.make(POGO), TC.make(POGO, device="cpu")
    for e in (ref, env):
        np.random.seed(7)
        e.reset()
        e.block_items("tree_log", "wall")
    assert views(env) == views(ref)
    rows, cols = np.where(ref.map == ref.items_id["crafting_table"])
    loc = (int(rows[0]), int(cols[0]))
    lasts = {"last_action": "Forward", "step_count": 5,
             "last_step_cost": 3.5, "last_reward": 2.0, "last_done": False}
    for e in (ref, env):
        e.add_fence_around(loc, "wall")
        e.set_lasts(lasts)
    assert views(env) == views(ref)
    assert env.last_step_cost == ref.last_step_cost == 3.5
    assert env.last_done is ref.last_done is False
    free = [(r, c) for r in range(2, 8) for c in range(2, 8)
            if ref.map[r, c] == 0][0]
    for e in (ref, env):
        e.set_agent_location(*free)
        e.set_agent_facing("EAST")
    assert views(env) == views(ref)
    assert_state_equal(env._state, ref._state)
    rng = np.random.RandomState(2)
    for t in range(20):
        a = int(rng.randint(ref.action_space.n))
        o_j, *rest_j = ref.step(a)
        o_t, *rest_t = env.step(a)
        assert_obs_equal(o_t, o_j, t)
        assert rest_t == rest_j, t
    for e in (ref, env):
        np.random.seed(11)
        e.add_new_items({"rock": 2})
    assert env.items_id == ref.items_id and "Select_rock" not in env.actions_id
    assert env.items_quantity == ref.items_quantity
    assert_state_equal(env._state, ref._state)
    play_both(ref, env, seed=9, episodes=1, cap=30)


def test_block_item_matches_ngx():
    """BlockItem fences every crafting_table after a successful extraction
    (novelty_wrappers.py:1232-1264); the map is set through ``_state``, whose
    assignment takes the port's host snapshot."""
    wraps = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        env = M.make(POGO, **kw)
        np.random.seed(5)
        env.reset()
        wraps.append(M.BlockItem(env))
    ref, w = wraps
    assert w.items_id == ref.items_id and "Select_fence" not in w.actions_id
    m = np.asarray(ref.map).copy()
    ct = ref.items_id["crafting_table"]
    row = 4 if not np.any(m[4, 4:7] == ct) else 6
    m[row, 5] = ref.items_id["tree_tap"]
    m[row, 6] = ref.items_id["tree_log"]
    ref.env._state = ref.env._state.replace(map=m.reshape(-1))
    w.env._state = w.env._state.replace(
        map=torch.as_tensor(m.reshape(1, -1)))
    for e in wraps:
        e.env.set_agent_location(row, 4)
        e.env.set_agent_facing("EAST")
    o_j, r_j, d_j, i_j = ref.step(ref.actions_id["Extract_rubber"])
    o_t, r_t, d_t, i_t = w.step(w.actions_id["Extract_rubber"])
    assert i_t["result"] and (r_t, d_t, i_t) == (r_j, d_j, i_j)
    assert_obs_equal(o_t, o_j, "extract")
    assert views(w) == views(ref)
    assert (w.map == w.items_id["fence"]).sum() > 0


def test_remap_action_matches_ngx(capsys):
    """v0's remap draws from the stdlib ``random`` (novel_gridworld_v0_env.py
    :271-285); over a LimitActions the remapaction novelty shuffles only the
    limited table, by ``np.random`` (novelty_wrappers.py:1209-1210)."""
    envs = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        env = M.make("NovelGridworld-v0", **kw)
        random.seed(3)
        env.remap_action()
        envs.append(env)
    ref, env = envs
    assert env.action_str == ref.action_str
    play_both(ref, env, seed=1, episodes=1, cap=20)

    envs = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        np.random.seed(6)
        envs.append(M.inject_novelty(
            M.LimitActions(M.make(POGO, **kw), LIMITED), "remapaction",
            "hard"))
    ref, env = envs
    assert env.limited_actions_id == ref.limited_actions_id
    assert env.limited_actions_id != {a: i for i, a in
                                      enumerate(sorted(LIMITED))}
    play_both(ref, env, seed=2, episodes=1, cap=30)
    assert "New remapped actions" in capsys.readouterr().out


def test_render_rgb_array_matches_ngx():
    imgs = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        env = M.make(POGO, **kw)
        np.random.seed(0)
        env.reset()
        env.step(0)
        imgs.append(env.render(mode="rgb_array"))
    assert imgs[1].ndim == 3 and imgs[1].shape[2] == 3
    assert imgs[1].shape == imgs[0].shape


def test_save_trajectories_matches_ngx(tmp_path):
    """SaveTrajectories writes ngx's pickle layout (wrappers.py:9-54)."""
    trajs = []
    for M, kw, d in ((C, {}, "j"), (TC, {"device": "cpu"}, "t")):
        env = M.SaveTrajectories(M.make(POGO, **kw), str(tmp_path / d))
        np.random.seed(0)
        env.reset()
        for a in [0, 1, 2, 3, 9, 0]:
            env.step(a)
        with open(env.save(), "rb") as f:
            trajs.append(pickle.load(f))
    ref, got = trajs
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert g[k].dtype == r[k].dtype and g[k].shape == (10, 10)
                np.testing.assert_array_equal(g[k], r[k])
            else:
                assert g[k] == r[k], k
    assert len(os.listdir(tmp_path / "t")) == 1


@pytest.mark.parametrize("env_id", [POGO, "NovelGridworld-v3"])
def test_native_reset_is_ngxs(env_id):
    """'native' reset k of the facade is ngx's facade's from the same seed,
    state and obs bit for bit (both split their key once a reset);
    ``seed()`` restarts both keys."""
    env = TC.make(env_id, reset_mode="native", seed=5, device="cpu")
    ref = C.make(env_id, reset_mode="native", seed=5)
    for k in range(3):
        obs, want = env.reset(), ref.reset()
        assert_state_equal(env._state, ref._state)
        assert_obs_equal(obs, want, f"native reset {k}")
    env.seed(9)
    ref.seed(9)
    for k in range(2):
        obs, want = env.reset(), ref.reset()
        assert_state_equal(env._state, ref._state)
        assert_obs_equal(obs, want, f"native reset {k} after seed(9)")


def test_make_defaults_to_the_card():
    """No device named: the card, or an error where there is none — never a
    quiet fall back to the CPU."""
    if torch.cuda.is_available():
        assert TC.make(POGO).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.make(POGO)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mirror_t(nt.make_spec(POGO))


def test_facade_and_drivers_import_without_jax():
    """The facade, the experts, SB2 and the drivers import and step with
    jax blocked, and load nothing of ngx."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "import ngx_torch.compat as TC, ngx_torch.core.mirror\n"
            "import ngx_torch.rl.experts, ngx_torch.rl.sb2\n"
            "import ngx_torch.cli.enjoy, ngx_torch.cli.record_demos\n"
            "import ngx_torch.cli.dagger\n"
            "from ngx_torch.rl.experts import get_expert\n"
            "env = TC.make('NovelGridworld-v0', device='cpu')\n"
            "np.random.seed(0)\n"
            "env.reset()\n"
            "env.step(get_expert('NovelGridworld-v0')(env))\n"
            "assert 'ngx' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("case", ["unknown-id", "crate-without-break"])
def test_limit_actions_asserts_match_ngx(case):
    """LimitActions' per-step asserts and the novelty asserts above it
    (wrappers.py:74-83, novelty_wrappers.py:1079-1081) raise ngx's
    messages word for word."""
    limited = {"Forward", "Left", "Right"}
    errors = []
    for M, kw in ((C, {}), (TC, {"device": "cpu"})):
        np.random.seed(1)
        env = M.LimitActions(M.make(POGO, **kw), limited)
        if case == "crate-without-break":
            env = M.inject_novelty(env, "crate", "easy")
        np.random.seed(2)
        env.reset()
        with pytest.raises(AssertionError) as err:
            env.step(3 if case == "unknown-id" else 0)
        errors.append(str(err.value))
    assert errors[1] == errors[0] and errors[0]
