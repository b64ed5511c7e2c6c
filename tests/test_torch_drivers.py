"""The port's drivers on the single-env facade — ngx_torch/cli/
record_demos.py, dagger.py and enjoy.py, and ngx_torch/rl/sb2.py — against
ngx's on the CPU.

Where a driver draws only from ``np.random`` (random actions, the scripted
expert, DAgger's beta mixing) its output must be ngx's exactly.  A policy
draws from ngx's keys (``policy(key, obs)``), as ngx's does; the tests
here hold what those paths write and read back, and
tests/test_torch_keyed_drivers.py holds them against ngx's outputs."""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

import jax

import ngx_torch as nt
from ngx_torch.ops import threefry as TF

torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
SOLVER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "trained_agents_torch", f"{POGO}_solver", "best.pt")
CHAIN = os.path.join(os.path.dirname(SOLVER), "..", "chain")
NPZ_KEYS = ("actions", "episode_returns", "rewards", "obs", "episode_starts")


def write_sb2_zip(path, obs_dim, n_actions, seed=0, hidden=(64, 64)):
    """An SB2 model zip of seeded numpy weights: its ``parameters`` member
    an npz keyed by TF variable names, as the reference's zips hold."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for tower, head, out in (("pi", "pi", n_actions), ("vf", "vf", 1)):
        dims = (obs_dim,) + hidden
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            arrays[f"model/{tower}_fc{i}/w:0"] = rng.normal(0, 0.3, (a, b))
            arrays[f"model/{tower}_fc{i}/b:0"] = rng.normal(0, 0.1, (b,))
        arrays[f"model/{head}/w:0"] = rng.normal(0, 0.3, (hidden[-1], out))
        arrays[f"model/{head}/b:0"] = rng.normal(0, 0.1, (out,))
    buf = io.BytesIO()
    np.savez(buf, **{k: v.astype(np.float32) for k, v in arrays.items()})
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("data", "{}")
        z.writestr("parameters", buf.getvalue())
    return path


@pytest.mark.parametrize("policy", ["random", "expert"])
def test_record_demos_matches_ngx(tmp_path, policy):
    from ngx.cli.record_demos import main as main_j
    from ngx_torch.cli.record_demos import main

    argv = ["-env", "NovelGridworld-Bow-v1", "-episodes", "3",
            "-episode_cap", "60", "-policy", policy, "-seed", "4"]
    main_j(argv + ["-out", str(tmp_path / "j.npz")])
    main(argv + ["-out", str(tmp_path / "t" / "t.npz"), "-device", "cpu"])
    with np.load(tmp_path / "j.npz") as zj, \
            np.load(tmp_path / "t" / "t.npz") as zt:
        assert sorted(zt.files) == sorted(NPZ_KEYS)
        for k in NPZ_KEYS:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zt["obs"].ndim == 2 and zt["actions"].shape[1] == 1


def test_record_demos_ckpt_layout(tmp_path):
    """``-policy ckpt`` with the converted Pogostick-v1 solver: ngx's npz
    layout, keyed actions inside the action space, and the same file again
    from the same seed."""
    from ngx_torch.cli.record_demos import main

    outs = []
    for name in ("a.npz", "b.npz"):
        main(["-env", POGO, "-episodes", "2", "-policy", "ckpt", "-ckpt",
              SOLVER, "-seed", "1", "-out", str(tmp_path / name),
              "-device", "cpu"])
        outs.append(dict(np.load(tmp_path / name)))
    a, b = outs
    n = a["obs"].shape[0]
    assert a["obs"].shape == (n, 63) and a["obs"].dtype == np.float64
    assert a["actions"].shape == (n, 1) and a["actions"].dtype == np.int64
    assert a["episode_starts"].sum() == 2 and a["episode_starts"][0]
    assert ((0 <= a["actions"]) & (a["actions"] < 17)).all()
    for k in NPZ_KEYS:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mix", [None, 1.0])
def test_collect_policy_labeled_matches_ngx(mix):
    """Round 0 (the expert rolls) and full beta-mixing (the expert's action
    executed at every step, the mixing draws ngx's ``RandomState``) give
    ngx's frames and labels."""
    from ngx.cli.dagger import collect_policy_labeled as collect_j
    from ngx.rl.models import ActorCritic as FlaxActorCritic
    from ngx_torch.cli.dagger import collect_policy_labeled
    from ngx_torch.rl.models import ActorCritic

    env_id = "NovelGridworld-Pogostick-v0"
    params_j = params_t = None
    if mix is not None:
        model = FlaxActorCritic(n_actions=20, hidden=(16, 16))
        params_j = model.init(jax.random.key(0), np.zeros((1, 63), np.float32))
        params_t = ActorCritic(63, 20, (16, 16)).load_flax_params(
            jax.tree_util.tree_map(np.asarray, params_j))
    kw = {} if mix is None else {"mix_expert": mix}
    obs_j, lab_j = collect_j(env_id, params_j, (16, 16), 3, 50, 2, **kw)
    obs_t, lab_t = collect_policy_labeled(env_id, params_t, (16, 16), 3, 50,
                                          2, device="cpu", **kw)
    assert obs_t.dtype == obs_j.dtype and lab_t.dtype == lab_j.dtype
    np.testing.assert_array_equal(obs_t, obs_j)
    np.testing.assert_array_equal(lab_t, lab_j)


def test_dagger_cli_writes_a_checkpoint_enjoy_reads(tmp_path, capsys):
    from ngx_torch.cli.dagger import main
    from ngx_torch.cli.enjoy import load_policy
    from ngx_torch.utils.checkpoint import restore_checkpoint

    ckpt = str(tmp_path / "dagger")
    out = main(["-env", "NovelGridworld-v0", "-rounds", "2",
                "-episodes_per_round", "4", "-bc_steps", "100",
                "-eval_episodes", "16", "-sharpen", "1,2", "-ckpt", ckpt,
                "-device", "cpu"])
    assert out["best"] is not None and set(out["seconds"]) == \
        {"collect", "bc", "eval"}
    tree = restore_checkpoint(os.path.join(ckpt, "best.pt"))
    assert set(tree["config"]) == {"hidden", "solve_frac", "mean_ep_return",
                                   "dagger_round", "sharpen_tau"}
    assert tree["config"]["hidden"] == [64, 64]
    assert tree["config"]["solve_frac"] == out["best"][0]
    import ngx_torch.compat as TC

    env = TC.LidarInFront(TC.make("NovelGridworld-v0", device="cpu"))
    np.random.seed(0)
    obs = env.reset()
    assert tree["params"]["pi_0.weight"].shape[1] == obs.shape[0]
    policy = load_policy(os.path.join(ckpt, "best.pt"), env.spec, "cpu")
    keys = TF.split(TF.key(0), 3)
    assert [policy(k, obs) for k in keys] == [policy(k, obs) for k in keys]
    assert 0 <= policy(keys[0], obs) < env.action_space.n
    assert "round 1:" in capsys.readouterr().out


def test_sb2_apply_matches_ngx(tmp_path):
    from ngx.rl.sb2 import load_sb2_params as load_j, sb2_apply as apply_j
    from ngx_torch.rl.sb2 import (check_dims, load_sb2_params, sb2_apply,
                                  sb2_to_device)

    path = write_sb2_zip(str(tmp_path / "v0.zip"), 10, 3, seed=5)
    p_t, p_j = load_sb2_params(path), load_j(path)
    assert [w.shape for w, _ in p_t["pi"]] == [w.shape for w, _ in p_j["pi"]]
    obs = np.random.RandomState(0).uniform(0, 10, (7, 10)).astype(np.float32)
    logits_j, value_j = jax.jit(apply_j)(p_j, obs)
    # float32 throughout; the two matmuls sum in different orders, so the
    # logits (up to ~6 here) agree to 1e-6 relative and absolute
    for p in (p_t, sb2_to_device(p_t, "cpu")):
        logits, value = sb2_apply(p, torch.as_tensor(obs))
        assert logits.dtype == value.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(value.numpy(), np.asarray(value_j),
                                   rtol=1e-6, atol=1e-6)
    check_dims(p_t, 10, 3)
    with pytest.raises(ValueError) as err:
        check_dims(p_t, 32, 3, "x.zip")
    assert str(err.value) == (
        "SB2 checkpoint x.zip expects obs_dim=10, n_actions=3; the env spec "
        "has obs_dim=32, n_actions=3")


def test_sb2_zip_through_evaluate_and_enjoy(tmp_path, capsys):
    """``evaluate_sb2_zip`` and ``enjoy -ckpt <zip>`` run a test-built zip
    on the env's own observation; a zip of another env fails its dims."""
    from ngx_torch.cli.enjoy import load_policy, main
    from ngx_torch.rl.evaluate import evaluate_sb2_zip

    path = write_sb2_zip(str(tmp_path / "v0.zip"), 10, 3, seed=1)
    m = evaluate_sb2_zip("NovelGridworld-v0", path, episodes=16, cap=20,
                         device="cpu")
    assert set(m) == {"mean_return", "solve_rate", "done_rate",
                      "mean_length"}
    assert 0 <= m["solve_rate"] <= m["done_rate"] <= 1
    assert 1 <= m["mean_length"] <= 20
    main(["-env", "NovelGridworld-v0", "-episodes", "2", "-episode_cap",
          "20", "-ckpt", path, "-device", "cpu"])
    assert "mean return over 2 episodes" in capsys.readouterr().out
    with pytest.raises(ValueError, match="obs_dim=10"):
        load_policy(path, nt.make_spec("NovelGridworld-v1"), "cpu")


def test_enjoy_v5_chain_matches_ngx_and_runs_the_chain_agents(capsys):
    """The v5 chain path: with random actions (no ``-ckpt``) every stage's
    episode is ngx's, line for line; with ``trained_agents_torch/chain``
    the v2-v4 stages act through the converted agents."""
    from ngx.cli.enjoy import main as main_j
    from ngx_torch.cli.enjoy import main

    argv = ["-env", "NovelGridworld-v5", "-episode_cap", "40", "-seed", "3"]
    main_j(argv)
    want = capsys.readouterr().out
    main(argv + ["-device", "cpu"])
    assert capsys.readouterr().out == want
    assert want.count("RESTORING LAST ENV ...") == 4
    main(argv + ["-ckpt", CHAIN, "-device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("--- stage") == 5 and "stage 4: NovelGridworld-v3" in out
