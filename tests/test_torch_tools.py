"""The port's last modules against ngx's on the CPU: the trajectory
recorder (ngx_torch/transforms/trajectories.py), the Monitor CSV
(ngx_torch/utils/monitor.py), and the drivers plot_results, keyboard_play,
socket_env / socket_agent and eval_agents (ngx_torch/cli/).

Everything here draws from ``np.random`` only (the facade's mirror reset,
``action_space.sample``), so the outputs must be ngx's exactly, apart from
eval_agents' policy, random and chain rows, which draw from ngx's keys and
are held against ngx's numbers in tests/test_torch_keyed_drivers.py."""

import contextlib
import io
import json
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ngx_torch as nt
import ngx_torch.compat as TC
from ngx_torch.cli.socket_agent import free_port, serve_and_talk
from ngx_torch.core.state import EnvState

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POGO = "NovelGridworld-Pogostick-v1"


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


# ---- TrajectoryRecorder -----------------------------------------------------

def _episode_states(env_id, seed, steps):
    """The [1]-batched facade states of a seeded random episode (CPU)."""
    np.random.seed(seed)
    env = TC.make(env_id, device="cpu")
    env.reset()
    states = [env.get_state()]
    for _ in range(steps):
        _, _, done, _ = env.step(env.action_space.sample())
        states.append(env.get_state())
        if done:
            break
    return states


@pytest.mark.parametrize("env_id", [POGO, "NovelGridworld-v3"])
def test_trajectory_recorder_matches_ngx(tmp_path, env_id):
    """Per-step chunks and one time-stacked chunk: the pickle loads to
    ngx's list, key for key, type for type."""
    import ngx
    from ngx.transforms import TrajectoryRecorder as RecJ
    from ngx_torch.transforms import TrajectoryRecorder

    states = _episode_states(env_id, 7, 25)
    stacked = EnvState(**{k: torch.cat([getattr(s, k) for s in states[5:]])
                          for k in states[0].to_numpy()})
    rec = TrajectoryRecorder(nt.make_spec(env_id), str(tmp_path / "t"))
    rec_j = RecJ(ngx.make_spec(env_id), str(tmp_path / "j"))
    for s in states[:5]:
        rec.record(s)
        rec_j.record(ngx.EnvState(**{k: jnp.asarray(v[0])
                                     for k, v in s.to_numpy().items()}))
    rec.record(stacked)
    rec_j.record(ngx.EnvState(**{k: jnp.asarray(v)
                                 for k, v in stacked.to_numpy().items()}))
    with contextlib.redirect_stdout(io.StringIO()):
        paths = rec.save(), rec_j.save()
    got, want = (pickle.load(open(p, "rb")) for p in paths)
    assert len(got) == len(states) > 5
    assert same(got, want)
    assert os.path.basename(paths[0]).endswith(f"_{env_id}.bin")


# ---- Monitor, load_results, ts2xy, plot_results -----------------------------

def _monitored(C, Monitor, log, env_id, **kw):
    np.random.seed(0)
    env = Monitor(C.make(env_id, **kw), str(log))
    for _ in range(3):
        env.reset()
        for t in range(60):
            _, _, done, _ = env.step(env.action_space.sample())
            if done:
                break
    env.close()


@pytest.mark.parametrize("env_id", ["NovelGridworld-v0", "NovelGridworld-v2"])
def test_monitor_matches_ngx(tmp_path, env_id):
    import ngx.compat as C
    from ngx.utils.monitor import Monitor as MonJ
    from ngx.utils.monitor import load_results as load_j
    from ngx.utils.monitor import ts2xy as ts2xy_j
    from ngx_torch.utils import Monitor, load_results, ts2xy

    _monitored(C, MonJ, tmp_path / "j", env_id)
    _monitored(TC, Monitor, tmp_path / "t", env_id, device="cpu")
    rows, rows_j = load_results(str(tmp_path / "t")), \
        load_j(str(tmp_path / "j"))
    assert len(rows) == len(rows_j) >= 1
    assert [(r["r"], r["l"]) for r in rows] == \
        [(r["r"], r["l"]) for r in rows_j]
    for xaxis in ("timesteps", "episodes"):
        for a, b in zip(ts2xy(rows, xaxis), ts2xy_j(rows_j, xaxis)):
            np.testing.assert_array_equal(a, b)
    with open(tmp_path / "t" / "monitor.csv") as f:
        header = json.loads(f.readline()[1:])
        assert f.readline().strip() == "r,l,t"
    assert header["env_id"] == env_id and set(header) == {"t_start",
                                                          "env_id"}


def test_load_results_reads_train_csv(tmp_path):
    """The training CLI's progress.monitor.csv loads, one row an update."""
    from ngx_torch.cli import train
    from ngx_torch.utils import load_results, ts2xy

    with contextlib.redirect_stdout(io.StringIO()):
        train.main(["-env", POGO, "-num_envs", "128", "-rollout", "4",
                    "-epochs", "1", "-episode_cap", "6", "-device", "cpu",
                    "-steps", "1024", "-log", str(tmp_path / "log")])
    rows = load_results(str(tmp_path / "log"))
    assert len(rows) == 2
    x, y = ts2xy(rows, "episodes")
    assert list(x) == [0, 1] and np.isfinite(y).all()


def test_plot_results_matches_ngx(tmp_path):
    """The PNG is written and each curve's (x, y) is ngx's over the same
    CSVs."""
    import ngx.compat as C
    from ngx.utils.monitor import Monitor as MonJ
    from ngx.utils.monitor import load_results as load_j
    from ngx.utils.monitor import ts2xy as ts2xy_j
    from ngx_torch.cli.plot_results import main as plot

    for name, env_id in (("a", "NovelGridworld-v0"),
                         ("b", "NovelGridworld-v2")):
        _monitored(C, MonJ, tmp_path / name, env_id)
    for xaxis in ("timesteps", "episodes"):
        out = tmp_path / f"lc_{xaxis}.png"
        with contextlib.redirect_stdout(io.StringIO()):
            curves = plot(["-log", str(tmp_path), "-xaxis", xaxis,
                           "-out", str(out)])
        assert out.stat().st_size > 0
        assert sorted(curves) == ["a", "b"]
        for name, (x, y) in curves.items():
            xj, yj = ts2xy_j(load_j(str(tmp_path / name)), xaxis)
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)


# ---- keyboard_play ----------------------------------------------------------

KEYS = {
    POGO: ["w", "a", "e", "1", "Forward", "xyz", "d", "w", "e", "b", "2",
           "x", "w", "w", "e", "e"],
    "NovelGridworld-v0": ["w"] * 12 + ["a", "w", "w", "d", "w", "w", "w"],
    "NovelGridworld-Bow-v1": ["e", "w", "e", "a", "q", "w", "e", "3", "x"],
}


@pytest.mark.parametrize("env_id,extra", [
    (POGO, []), ("NovelGridworld-v0", []),
    ("NovelGridworld-Bow-v1", ["-novelty", "axe", "-difficulty", "easy",
                               "-arg1", "wooden"])])
def test_keyboard_play_matches_ngx(monkeypatch, env_id, extra):
    """A scripted stdin: the port's transcript is ngx's, line for line."""
    from ngx.cli.keyboard_play import main as main_j
    from ngx_torch.cli.keyboard_play import main

    argv = ["-env", env_id, "-seed", "3", *extra]
    outs = []
    for run in (lambda: main_j(argv), lambda: main(argv + ["-device",
                                                           "cpu"])):
        monkeypatch.setattr(sys, "stdin",
                            io.StringIO("\n".join(KEYS[env_id] + ["quit"])))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        outs.append(buf.getvalue().splitlines())
    got, want = outs[1], outs[0]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"line {i}"
    assert sum(line.startswith("action> action:") for line in got) >= 8


# ---- socket_env / socket_agent ----------------------------------------------

@pytest.mark.parametrize("env_id", ["NovelGridworld-v6", "NovelGridworld-v1"])
def test_socket_serve_matches_ngx(env_id):
    """The same actions to ngx's server and the port's: the same bytes."""
    import ngx.compat as C
    from ngx.cli.socket_env import serve as serve_j
    from ngx_torch.cli.socket_env import serve

    spec = nt.make_spec(env_id)
    rng = np.random.RandomState(11)
    actions = [spec.actions[int(rng.randint(spec.n_actions))]
               for _ in range(20)]
    out = {}
    for tag, srv, make in (("j", serve_j, lambda: C.make(env_id)),
                           ("t", serve,
                            lambda: TC.make(env_id, device="cpu"))):
        np.random.seed(5)
        out[tag] = serve_and_talk(srv, make(), actions)[0]
    assert out["t"] == out["j"]
    for reply in out["t"]:
        msg = json.loads(reply)
        assert set(msg) == {"observation", "reward", "done"}
        assert isinstance(msg["reward"], float)


def test_socket_agent_talks_to_serve():
    """socket_agent's protocol against the port's server: one reply an
    action, the reply a JSON line."""
    from ngx_torch.cli.socket_agent import main as agent
    from ngx_torch.cli.socket_env import serve

    np.random.seed(2)
    port = free_port()
    t = threading.Thread(target=serve, daemon=True, kwargs=dict(
        env=TC.make("NovelGridworld-v6", device="cpu"), port=port,
        max_steps=6))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t.start()
        agent(["-port", str(port), "-steps", "6", "-device", "cpu"])
        t.join(timeout=30)
    assert not t.is_alive()
    lines = buf.getvalue().splitlines()
    got = [line for line in lines if line.startswith("Received observation")]
    assert len(got) == 6
    assert sum(line.startswith("Sending action") for line in lines) == 6
    assert all('"observation"' in line for line in got)


# ---- eval_agents ------------------------------------------------------------

def test_eval_agents_report_matches_ngx(tmp_path):
    """All 11 envs at 4 episodes on the CPU: ngx's report keys and markdown
    row layout; the expert rows equal ngx's evaluate_expert; a
    -ref_agents zip yields the 'reference' row (the keyed rows' numbers:
    tests/test_torch_keyed_drivers.py)."""
    from ngx.rl.evaluate import evaluate_expert
    from ngx_torch.cli.eval_agents import ENV_IDS, main
    from test_torch_drivers import write_sb2_zip

    ref = tmp_path / "ref"
    ref.mkdir()
    write_sb2_zip(str(ref / "NovelGridworld-v0.zip"), 10, 3, seed=4)
    out, md = tmp_path / "eval.json", tmp_path / "EVAL.md"
    with contextlib.redirect_stdout(io.StringIO()):
        report = main(["-episodes", "4", "-device", "cpu",
                       "-agents", os.path.join(ROOT, "trained_agents_torch"),
                       "-ref_agents", str(ref), "-out", str(out),
                       "-md", str(md)])
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "results", "eval.json")) as f:
        ngx_report = json.load(f)
    assert list(got) == ["episodes", "episode_cap", "seed", "envs", "chain",
                         "chain_solver"]
    assert list(got["envs"]) == ENV_IDS
    metric_keys = set(ngx_report["envs"]["NovelGridworld-v0"]["trained"])
    for env_id, res in got["envs"].items():
        want = set(ngx_report["envs"][env_id]) - {"reference"}
        if env_id == "NovelGridworld-v0":
            want.add("reference")
        assert set(res) == want, env_id
        for row in ("trained", "random", "expert", "solver", "reference"):
            if row in res:
                assert set(res[row]) == metric_keys, (env_id, row)
        assert res["checkpoint"] == f"{env_id}/best.pt"
        assert res["expert"] == evaluate_expert(env_id, episodes=4, cap=100,
                                                seed=0), env_id
    assert set(got["chain"]) == {"mean_return", "solve_rate", "done_rate"}
    assert set(report["seconds"]) == set(ENV_IDS) | {"chain"}
    lines = md.read_text().splitlines()
    with open(os.path.join(ROOT, "docs", "EVAL.md")) as f:
        ngx_lines = f.read().splitlines()
    head = next(i for i, s in enumerate(ngx_lines) if s.startswith("| Env"))
    i = lines.index(ngx_lines[head])
    assert lines[i + 1] == ngx_lines[head + 1]
    rows = lines[i + 2:i + 2 + len(ENV_IDS)]
    assert [r.split(" | ")[0] for r in rows] == [f"| {e}" for e in ENV_IDS]
    assert all(r.count("|") == ngx_lines[head + 2].count("|") for r in rows)
    text = md.read_text()
    for claim in ("v5e", "TPU", "M env steps", "96%", "90%", "ngx/rl/",
                  "trained_agents/"):
        assert claim not in text, claim


# ---- imports and devices ----------------------------------------------------

def test_new_modules_import_without_jax_or_matplotlib():
    """The new modules import with jax and matplotlib blocked (the card's
    machine has neither) and load nothing of ngx."""
    import subprocess

    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import ngx_torch.utils.debug, ngx_torch.utils.monitor\n"
            "import ngx_torch.transforms.trajectories\n"
            "import ngx_torch.cli.eval_agents, ngx_torch.cli.keyboard_play\n"
            "import ngx_torch.cli.socket_env, ngx_torch.cli.socket_agent\n"
            "import ngx_torch.cli.plot_results\n"
            "from ngx_torch.rl import ActorCritic, PPOConfig, make_train, "
            "dryrun\n"
            "from ngx_torch.utils import Monitor, load_results, ts2xy, "
            "restore_checkpoint, save_checkpoint\n"
            "from ngx_torch.transforms import TrajectoryRecorder\n"
            "assert 'ngx' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_new_entry_points_default_to_the_card(tmp_path):
    """Without -device each driver asks for the card, and raises here
    before it binds, connects or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from ngx_torch.cli import eval_agents, keyboard_play, socket_agent
    from ngx_torch.cli import socket_env

    out = tmp_path / "eval.json"
    runs = [
        lambda: eval_agents.main(["-envs", POGO, "-out", str(out),
                                  "-md", ""]),
        lambda: keyboard_play.main([]),
        lambda: socket_env.main(["-port", str(free_port())]),
        lambda: socket_agent.main(["-port", str(free_port())]),
    ]
    for run in runs:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert not out.exists()
