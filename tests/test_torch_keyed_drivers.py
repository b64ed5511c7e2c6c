"""The port's drivers on ngx's keys against ngx's on the CPU, from the same
arguments: ``enjoy``, ``record_demos -policy ckpt``, ``dagger``
(``collect_policy_labeled`` and ``main``), ``eval_agents`` and ``perf``'s
keyed paths (ngx_torch/cli/), and ``KeyedVecEnv.scan``'s 'hash' and
'fixed' actions (ngx_torch/vector).

Both sides act through the same weights: ngx's checkpoint against its
converted ``.pt`` under ``trained_agents_torch/``, a flax init carried over
by ``load_flax_params``, or a seeded SB2 zip.  A policy's action is
``categorical(k, logits)`` over logits that differ from flax's by float
rounding, so an action could flip only at a Gumbel near-tie (the
first-mismatch rule of PERF.md section 2).  On these arguments none
flips: every test here allows 0 mismatches and holds the outputs equal."""

import contextlib
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ngx_torch.ops import threefry as TF

from test_torch_drivers import write_sb2_zip
from test_torch_keyed_train import ngx_draws
from test_torch_native_reset import _rows_differing, _specs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"
SOLVER_J = str(ROOT / "trained_agents" / f"{POGO}_solver" / "best")
SOLVER_T = str(ROOT / "trained_agents_torch" / f"{POGO}_solver" / "best.pt")
NPZ_KEYS = ("actions", "episode_returns", "rewards", "obs", "episode_starts")


def _printed(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


# ---- enjoy ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["solver", "sb2", "v5-chain"])
def test_keyed_enjoy_matches_ngx(case, tmp_path, capsys):
    """``enjoy`` prints ngx's episodes line for line: the Pogostick-v1
    solver (3 episodes, cap 60), a seeded SB2 zip on NovelGridworld-v0
    (its own 10-wide lidar obs), and the v5 restore chain through the chain
    agents, each stage from ``key(seed)`` again."""
    from ngx.cli.enjoy import main as main_j
    from ngx_torch.cli.enjoy import main

    if case == "solver":
        argv = ["-env", POGO, "-episodes", "3", "-episode_cap", "60",
                "-seed", "2"]
        ckpt_j, ckpt_t = SOLVER_J, SOLVER_T
    elif case == "sb2":
        argv = ["-env", "NovelGridworld-v0", "-episodes", "3",
                "-episode_cap", "40", "-seed", "1"]
        ckpt_j = ckpt_t = write_sb2_zip(str(tmp_path / "v0.zip"), 10, 3,
                                        seed=3)
    else:
        argv = ["-env", "NovelGridworld-v5", "-episode_cap", "60"]
        ckpt_j = str(ROOT / "trained_agents" / "chain")
        ckpt_t = str(ROOT / "trained_agents_torch" / "chain")
    want = _printed(main_j, argv + ["-ckpt", ckpt_j], capsys)
    got = _printed(main, argv + ["-ckpt", ckpt_t, "-device", "cpu"], capsys)
    assert got.splitlines() == want.splitlines()
    if case == "v5-chain":
        assert want.count("--- stage") == 5
    else:
        assert want.count("episode ") == 3


# ---- record_demos -----------------------------------------------------------

def test_keyed_record_demos_ckpt_matches_ngx(tmp_path):
    """``record_demos -policy ckpt`` with the Pogostick-v1 solver, 3
    episodes (one key for the run, a split a policy step): every array of
    the npz is ngx's."""
    from ngx.cli.record_demos import main as main_j
    from ngx_torch.cli.record_demos import main

    argv = ["-env", POGO, "-episodes", "3", "-episode_cap", "60",
            "-policy", "ckpt", "-seed", "5"]
    with contextlib.redirect_stdout(io.StringIO()):
        main_j(argv + ["-ckpt", SOLVER_J, "-out", str(tmp_path / "j.npz")])
        main(argv + ["-ckpt", SOLVER_T, "-out", str(tmp_path / "t.npz"),
                     "-device", "cpu"])
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zt.files) == sorted(NPZ_KEYS)
        for k in NPZ_KEYS:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zj["episode_starts"].sum() == 3


# ---- dagger -----------------------------------------------------------------

@pytest.mark.parametrize("mix", [None, 0.5])
def test_keyed_collect_policy_labeled_matches_ngx(mix):
    """A flax-initialised policy rolled with ngx's key schedule, without
    and with beta-mixing: ngx's frames and labels."""
    from ngx.cli.dagger import collect_policy_labeled as collect_j
    from ngx.rl.models import ActorCritic as FlaxActorCritic
    from ngx_torch.cli.dagger import collect_policy_labeled
    from ngx_torch.rl.models import ActorCritic

    env_id = "NovelGridworld-Pogostick-v0"
    model = FlaxActorCritic(n_actions=17, hidden=(16, 16))
    params_j = model.init(jax.random.key(4), np.zeros((1, 63), np.float32))
    params_t = ActorCritic(63, 17, (16, 16)).load_flax_params(
        jax.tree_util.tree_map(np.asarray, params_j))
    kw = {} if mix is None else {"mix_expert": mix}
    obs_j, lab_j = collect_j(env_id, params_j, (16, 16), 3, 40, 7, **kw)
    obs_t, lab_t = collect_policy_labeled(env_id, params_t, (16, 16), 3, 40,
                                          7, device="cpu", **kw)
    assert obs_t.dtype == obs_j.dtype and lab_t.dtype == lab_j.dtype
    np.testing.assert_array_equal(obs_t, obs_j)
    np.testing.assert_array_equal(lab_t, lab_j)


def test_keyed_dagger_rounds_match_ngx(tmp_path, capsys):
    """``dagger`` on NovelGridworld-v0, 2 rounds of 3 episodes, 50 BC
    steps, 16 evaluation episodes, taus 1 and 2: ngx's printed lines (the
    dataset sizes, ``bc_acc``, ``solve``, ``return`` and tau at their
    printed precision) and ngx's saved ``solve_frac`` / ``dagger_round`` /
    ``sharpen_tau``."""
    from ngx.cli.dagger import main as main_j
    from ngx.utils.checkpoint import restore_pytree
    from ngx_torch.cli.dagger import main
    from ngx_torch.utils.checkpoint import restore_checkpoint

    argv = ["-env", "NovelGridworld-v0", "-rounds", "2",
            "-episodes_per_round", "3", "-bc_steps", "50", "-eval_episodes",
            "16", "-sharpen", "1,2", "-seed", "3"]
    want = _printed(main_j, argv + ["-ckpt", str(tmp_path / "j")], capsys)
    main(argv + ["-ckpt", str(tmp_path / "t"), "-device", "cpu"])
    got = capsys.readouterr().out

    def rounds(text):
        return [s for s in text.splitlines()
                if s.startswith(("round ", "  saved", "best solve"))]

    assert rounds(got) == rounds(want) and len(rounds(want)) >= 3
    cfg_j = restore_pytree(str(tmp_path / "j" / "best"))["config"]
    cfg_t = restore_checkpoint(str(tmp_path / "t" / "best.pt"))["config"]
    for k in ("solve_frac", "dagger_round", "sharpen_tau"):
        assert float(cfg_t[k]) == float(cfg_j[k]), k


# ---- eval_agents ------------------------------------------------------------

def _doc_chain_numbers():
    """docs/EVAL.md's chain rows: ``(solve %, mean return text)`` for the
    chain agent and the chain solver, at the document's precision."""
    text = (ROOT / "docs" / "EVAL.md").read_text()
    found = re.findall(r"\*\*solve (\d+)%, mean return ([\d.]+)\*\*", text)
    assert len(found) == 2
    return found


def test_keyed_eval_agents_gives_ngx_report(tmp_path):
    """``eval_agents`` on v0 and Pogostick-v1 at 128 episodes, seed 0:
    the trained, random and solver rows are ``results/eval.json``'s, and
    the chain rows are ``docs/EVAL.md``'s (solve 0%, return 1421; solve
    100%, return 46.3) at the document's precision."""
    from ngx_torch.cli.eval_agents import main

    with contextlib.redirect_stdout(io.StringIO()):
        report = main(["-envs", f"NovelGridworld-v0,{POGO}", "-episodes",
                       "128", "-seed", "0", "-device", "cpu", "-agents",
                       str(ROOT / "trained_agents_torch"), "-ref_agents", "",
                       "-out", str(tmp_path / "e.json"),
                       "-md", str(tmp_path / "e.md")])
    with open(ROOT / "results" / "eval.json") as f:
        ngx_report = json.load(f)
    for env_id in ("NovelGridworld-v0", POGO):
        for row in ("trained", "random", "solver"):
            if row in ngx_report["envs"][env_id]:
                assert report["envs"][env_id][row] == \
                    ngx_report["envs"][env_id][row], (env_id, row)
    assert "solver" in report["envs"][POGO]
    for name, (solve, ret) in zip(("chain", "chain_solver"),
                                  _doc_chain_numbers()):
        got = report[name]
        digits = len(ret.split(".")[1]) if "." in ret else 0
        assert f"{got['solve_rate'] * 100:.0f}" == solve, (name, got)
        assert f"{got['mean_return']:.{digits}f}" == ret, (name, got)
    md = (tmp_path / "e.md").read_text()
    assert "counter RNG" not in md and "keys" in md


# ---- perf and the keyed scan --------------------------------------------------

def test_keyed_perf_trainer_draws_ngx_keys(monkeypatch, capsys):
    """``perf --trainer`` (B 128, one timed step) steps on ngx's keys:
    the seeds and permutations each step records are ngx's draws from
    ``key(1)`` (the warm-up), ``key(2)`` (the timed step) and ``key(3)``
    (by phase), at ngx's 64 rollout steps, on both backends."""
    from ngx.rl.train import PPOConfig as JCfg
    from ngx_torch.cli import perf
    from ngx_torch.rl import train as Tt

    real, seen = Tt.make_train, []

    def recording(*a, **kw):
        init, step = real(*a, **kw)

        def run(carry, key):
            out = step(carry, key)
            seen.append((kw["rollout_backend"], step.seeds,
                         [p.clone() for p in step.perms]))
            return out

        run.__dict__ = step.__dict__
        return init, run

    monkeypatch.setattr(Tt, "make_train", recording)
    perf.main(["-batch", "128", "-steps", "4", "-repeats", "1",
               "-device", "cpu", "--trainer"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 4 and set(out["steps_per_s"]) == {
        "train_step_xla", "train_step_pallas"}
    assert [b for b, _, _ in seen] == ["xla"] * 3 + ["pallas"] * 3
    cfg = JCfg(env_id=POGO, num_envs=128, rollout_steps=64)
    for i, (backend, seeds, perms) in enumerate(seen):
        want_seeds, want_perms = ngx_draws(cfg, jax.random.key(1 + i % 3),
                                           False, 128 * 64)
        # the unfused loop acts on the step's key itself: no kernel seed
        assert seeds == (want_seeds if backend == "pallas" else (None, None))
        assert len(perms) == len(want_perms)
        for p, q in zip(perms, want_perms):
            np.testing.assert_array_equal(p.numpy(), q)


def test_keyed_perf_policy_weights_are_flax_init(monkeypatch):
    """``perf --policy``'s weights are flax's ``init(key(1))`` over the
    obs width of ngx's native reset from ``key(0)``, within the 3-ulp
    spread of ``truncated_normal``."""
    import jax.numpy as jnp

    import ngx
    from ngx.rl.models import ActorCritic as FlaxActorCritic
    from ngx.transforms import lidar_in_front
    from ngx_torch.cli import perf
    from ngx_torch.ops import rollout as R

    kept = {}

    def make_rollout(*a, pi_layers=None, **kw):
        kept["layers"] = pi_layers
        raise StopIteration

    monkeypatch.setattr(R, "make_rollout", make_rollout)
    with pytest.raises(StopIteration):
        perf.main(["-batch", "128", "-steps", "4", "-device", "cpu",
                   "--policy", "-block", "64"])
    lspec = lidar_in_front(ngx.make_spec(POGO))
    obs0 = ngx.make_reset(lspec)(jax.random.key(0))[1]
    params = FlaxActorCritic(n_actions=lspec.n_actions, hidden=(64, 64)).init(
        jax.random.key(1), jnp.zeros((1, obs0.shape[0]), jnp.float32))
    names = ("pi_0", "pi_1", "pi_out")
    assert len(kept["layers"]) == len(names)
    for (w, b), name in zip(kept["layers"], names):
        want = np.asarray(params["params"][name]["kernel"]).T
        got = w.numpy()
        assert got.shape == want.shape
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= 3, name
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(params["params"][name]["bias"]))


@pytest.mark.parametrize("flags", [
    {"action_rng": "hash"}, {"action_rng": "fixed"},
    {"action_rng": "threefry", "auto_reset": False},
    {"action_rng": "threefry", "packed": True}],
    ids=["hash", "fixed", "no-auto-reset", "packed"])
def test_keyed_scan_variants_match_ngx(flags):
    """``throughput_fn(rng='threefry', ...)`` at B 64, T 16 on
    Pogostick-v1 from ``key(0)``: ngx's ``throughput_fn(...)(key(0))``
    final state bit for bit and its mean reward, for the variants ngx's
    perf breakdown runs beside its default scan."""
    from ngx.vector import throughput_fn as throughput_j
    from ngx_torch.vector import throughput_fn

    B, T = 64, 16
    spj, spt = _specs(POGO, ())
    st_j, mean_j = throughput_j(spj, B, T, **flags)(jax.random.key(0))
    st_t, mean_t = throughput_fn(spt, B, T, rng="threefry", device="cpu",
                                 **flags)(TF.key(0))
    n, fields = _rows_differing(st_j, st_t)
    assert n == 0, f"{n} of {B} envs differ from ngx's in {fields}"
    assert float(mean_t) == float(mean_j)


def test_keyed_scan_refuses_the_counter_draw():
    """On ngx's keys the actions are ngx's three draws: the kernel's
    counter draw is refused, and an unknown ``rng`` too."""
    import ngx_torch as nt
    from ngx_torch.vector import throughput_fn

    spec = nt.make_spec(POGO)
    with pytest.raises(ValueError, match="keyed scan"):
        throughput_fn(spec, 64, 2, rng="threefry", device="cpu")
    with pytest.raises(ValueError, match="rng"):
        throughput_fn(spec, 64, 2, rng="philox", device="cpu")
    with pytest.raises(ValueError, match="action_rng"):
        throughput_fn(spec, 64, 2, action_rng="threefry", rng="counter",
                      device="cpu")
