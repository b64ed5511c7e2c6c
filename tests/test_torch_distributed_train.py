"""The port's sharded PPO train step (ngx_torch.rl.train under an EnvMesh)
against ngx's make_train over a two-device mesh on the CPU.

ngx runs make_train(cfg, Mesh(jax.devices()[:2]), rollout_backend='pallas')
on the CPU's virtual devices, its Pallas kernel in interpret mode.  The
port runs two gloo ranks (spawn_ranks, one torch thread each, a time limit
each, one run at a time) on the mesh's keyed form from the same keys:
each rank's init is its rows of ngx's (ngx's parameters loaded over it, so
both update the same weights), and its step draws ngx's rollout seed, pool
seed and per-shard permutations (fold_in(k_upd, i) -> split(epochs) ->
permutation(T*B/2)), which are replayed here from ngx's key schedule and
checked.  Per shard the trajectory and the state are held bit for bit; the
parameters and losses at test_torch_ppo.py's tolerance (rtol 1e-5, atol
1e-6: the moment and gradient all-reduces add in another order than XLA's
psum).  No test here asserts a timing ratio."""

import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_ranks as R
import ngx
from ngx.ops import pallas_rollout as JP
from ngx.rl import train as J
from ngx.transforms import lidar_in_front
from ngx_torch import parallel as P
from ngx_torch.core.state import EnvState
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import train as Tt

torch.set_num_threads(1)

SPAWN_TIMEOUT = 300.0
B, T, W, HIDDEN, CAP = 256, 8, 2, (16, 16), 5
CFG = dict(num_envs=B, rollout_steps=T, num_minibatches=2, epochs=2,
           hidden=HIDDEN, episode_cap=CAP)
FIELDS = tuple(EnvState.__dataclass_fields__)
I32_MAX = int(jnp.iinfo(jnp.int32).max)


def _ngx_spec(name):
    if name == "fence":
        return ngx.inject_novelty(ngx.make_spec(R.POGO), *R.FENCE)
    return ngx.make_spec(R.POGO)


def _numpy_state(st):
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}


def _ngx_case(name):
    """ngx's sharded step from its init on ``key(0)``, the step on
    ``key(1)``, its draws replayed, and each shard's trajectory from ngx's
    kernel at the shard's seed."""
    spec = _ngx_spec(name)
    cfg = J.PPOConfig(**CFG)
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("env",))
    with mesh:
        init, step = J.make_train(cfg, mesh, spec_override=spec,
                                  rollout_backend="pallas")
        carry = init(jax.random.key(0))
        key = jax.random.key(1)
        carry2, metrics = jax.jit(step)(carry, key)
    k_roll, k_upd = jax.random.split(key)
    pool = name == "fence"
    if pool:
        k_seed, k_pool = jax.random.split(k_roll)
        pool_seed = int(jax.random.randint(k_pool, (), 0, I32_MAX))
    else:
        k_seed, pool_seed = k_roll, None
    roll_seed = int(jax.random.randint(k_seed, (), 0, I32_MAX))
    n = T * B // W
    perms = [[np.asarray(jax.random.permutation(k, n)) for k in
              jax.random.split(jax.random.fold_in(k_upd, i), cfg.epochs)]
             for i in range(W)]
    lspec = lidar_in_front(spec)
    run = JP.make_pallas_train_rollout(
        lspec, B // W, T, block=128, cap=CAP, hidden=HIDDEN, interpret=True,
        reset_source="pool" if pool else "native", pool_slots=Tt.POOL_SLOTS)
    run = jax.jit(run)
    st = carry[1]
    if pool:
        gpool = JP.make_xla_pool_reset(lspec, B * Tt.POOL_SLOTS)(pool_seed)
    shards = []
    for i in range(W):
        sl = slice(i * B // W, (i + 1) * B // W)
        args = (jnp.int32(P.shard_seed(roll_seed, i)),
                jax.tree_util.tree_map(lambda x: x[sl], st),
                carry[0].params)
        if pool:
            ps = slice(i * B // W * Tt.POOL_SLOTS,
                       (i + 1) * B // W * Tt.POOL_SLOTS)
            args += (jax.tree_util.tree_map(
                lambda x: x[ps].reshape((B // W, Tt.POOL_SLOTS)
                                        + x.shape[1:]), gpool),
                     jnp.zeros((B // W,), jnp.int32))
        shards.append(run(*args))
    case = {"cfg": CFG, "spec": "fence" if pool else R.POGO,
            "state": _numpy_state(st), "obs": np.asarray(carry[2]),
            "params": jax.tree_util.tree_map(np.asarray, carry[0].params),
            "roll_seed": roll_seed, "pool_seed": pool_seed, "perms": perms}
    return case, carry2, metrics, shards


@pytest.fixture(scope="module", params=["native", "fence"])
def run(request):
    """ngx's step, the two spawned gloo ranks', and the in-process twin's
    (two threads over make_local_meshes, gradients summed by hand)."""
    case, carry2, metrics, shards = _ngx_case(request.param)
    ranks = P.spawn_ranks(R.train_rank, W, (case,), device="cpu",
                          timeout=SPAWN_TIMEOUT)
    twin = [None] * W

    def thread(mesh):
        twin[mesh.rank] = P._to_host(R.train_rank(mesh, case))

    threads = [threading.Thread(target=thread, args=(m,))
               for m in P.make_local_meshes(W, "cpu")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return types.SimpleNamespace(name=request.param, case=case,
                                 carry2=carry2, metrics=metrics,
                                 shards=shards, ranks=ranks, twin=twin)


def test_sharded_train_step_matches_ngx(run):
    """Per shard: the init's state and obs its rows of ngx's, the step's
    rollout seed, pool seed and permutations ngx's, and the final state,
    the last obs and the trajectory (obs, actions, rewards, dones) bit for
    bit against ngx; the parameters and the global metrics at
    test_torch_ppo.py's tolerance, the counts exactly; on Pogostick-v1
    (native resets) and fence medium (the pool rows of the global pool)."""
    want_state = _numpy_state(run.carry2[1])
    want_obs = np.asarray(run.carry2[2])
    for i, got in enumerate(run.ranks):
        assert got["backend"] == "pallas"
        assert got["source"] == ("pool" if run.name == "fence" else "native")
        sl = slice(i * B // W, (i + 1) * B // W)
        for k in FIELDS:
            np.testing.assert_array_equal(
                got["init_state"][k], run.case["state"][k][sl].reshape(
                    got["init_state"][k].shape), err_msg=k)
        np.testing.assert_array_equal(got["init_obs"], run.case["obs"][sl])
        assert got["seeds"] == (run.case["roll_seed"],
                                run.case["pool_seed"])
        for g, w in zip(got["perms"], run.case["perms"][i]):
            np.testing.assert_array_equal(g, w)
        for k in FIELDS:
            np.testing.assert_array_equal(
                got["state"][k],
                want_state[k][sl].reshape(got["state"][k].shape), err_msg=k)
        np.testing.assert_array_equal(got["last_obs"], want_obs[sl])
        shard = run.shards[i]
        for k in FIELDS:
            np.testing.assert_array_equal(
                got["state"][k], np.asarray(getattr(shard[0], k)).reshape(
                    got["state"][k].shape), err_msg=k)
        for g, w in zip(got["rollout"], shard[1:5]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert int(got["rollout"][3].sum()) > 0        # boundaries on it
        pj = run.carry2[0].params["params"]
        for name, (wt, bias) in got["params"].items():
            np.testing.assert_allclose(wt.T, np.asarray(pj[name]["kernel"]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(bias, np.asarray(pj[name]["bias"]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        m_j = {k: float(v) for k, v in run.metrics.items()}
        m_t = got["metrics"]
        assert sorted(m_t) == sorted(m_j)
        for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum"):
            assert m_t[k] == m_j[k], k
        for k in ("ep_return_sum", "mean_reward", "v_loss", "entropy"):
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m_t["pg_loss"], m_j["pg_loss"], atol=1e-6)
    assert run.ranks[0]["metrics"] == run.ranks[1]["metrics"]


def test_spawned_ranks_match_in_process_twin(run):
    """Both ranks hold the same parameters after the step, and they are
    the in-process twin's bit for bit (a two-term float sum does not
    depend on its order); each rank's state and trajectory are its
    twin's."""
    p0, p1 = (r["params"] for r in run.ranks)
    for name in p0:
        for a, b, c in zip(p0[name], p1[name], run.twin[0]["params"][name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(a, c, err_msg=name)
    for got, twin in zip(run.ranks, run.twin):
        assert got["metrics"] == twin["metrics"]
        for k in FIELDS:
            np.testing.assert_array_equal(got["state"][k], twin["state"][k])
        for g, w in zip(got["rollout"], twin["rollout"]):
            np.testing.assert_array_equal(g, w)


def test_collective_audit(run):
    """A sharded train step runs only all-reduces (counterpart of
    tests/test_distributed.py:167): per minibatch one gradient all-reduce
    of exactly the parameter bytes and one of the two advantage moments,
    then one of the loss terms and one of the metrics — nothing the size
    of the env state or the trajectory."""
    nparams = sum(w.size + b.size for w, b in run.ranks[0]["params"].values())
    state_bytes = sum(v.nbytes for v in run.ranks[0]["state"].values())
    n_mb = CFG["epochs"] * CFG["num_minibatches"]
    for r in run.ranks:
        log = r["collectives"]
        assert {op for op, _, _ in log} == {"all_reduce"}
        assert log.count(("all_reduce", "grad", 4 * nparams)) == n_mb
        assert log.count(("all_reduce", "moments", 8)) == n_mb
        assert [t for _, t, _ in log[-2:]] == ["aux", "metrics"]
        assert len(log) == 2 * n_mb + 2
        assert all(n < state_bytes // 10 for _, t, n in log if t != "grad")


def test_mesh_bc_anchor_and_solve_shaping():
    """The shard-local update with the BC anchor and solve shaping (the
    solver recipe under a mesh, counterpart of
    tests/test_distributed.py:217): finite losses, the same global metrics
    and parameters on both ranks."""
    rng = np.random.RandomState(0)
    bc = (rng.rand(64, 63).astype(np.float32), np.zeros((64,), np.int32))
    cfg = dict(CFG, bc_coef=0.05, solve_shaped=True)
    case = {"cfg": cfg, "spec": R.POGO, "bc": bc}
    ranks = P.spawn_ranks(R.train_rank, W, (case,), device="cpu",
                          timeout=SPAWN_TIMEOUT)
    m = ranks[0]["metrics"]
    assert all(np.isfinite(v) for v in m.values()), m
    assert m == ranks[1]["metrics"]
    for name, (wt, _) in ranks[0]["params"].items():
        np.testing.assert_array_equal(wt, ranks[1]["params"][name][0])


def test_mesh_backend_rule_and_per_rank_gate():
    """Under a mesh 'auto' takes the acting kernel, as it does unsharded
    (ngx's 'auto' takes its unfused loop there, ngx/rl/train.py:256-262,
    because its Pallas kernel is picked on a single TPU only), and 'xla'
    the unfused loop only when asked for; the 128-env gate is on the
    per-rank batch; a mesh that is not an EnvMesh is refused."""
    meshes = P.make_local_meshes(2, "cpu")
    cfg = Tt.PPOConfig(**CFG)
    _, step = Tt.make_train(cfg, meshes[0])
    assert step.rollout_backend == "pallas" and step.reset_source == "native"
    _, step = Tt.make_train(cfg, meshes[0], spec_override=R.spec_of("fence"))
    assert step.rollout_backend == "pallas" and step.reset_source == "pool"
    _, step = Tt.make_train(cfg, meshes[0], rollout_backend="xla")
    assert step.rollout_backend == "xla" and step.reset_source == "vec"
    _, step = Tt.make_train(cfg, device="cpu")
    assert step.rollout_backend == "pallas"        # no mesh: the kernel
    with pytest.raises(ValueError, match="per-device batch 64"):
        Tt.make_train(Tt.PPOConfig(num_envs=128), meshes[0])
    with pytest.raises(ValueError, match="per-device batch"):
        Tt.make_train(Tt.PPOConfig(num_envs=384), P.make_local_meshes(
            4, "cpu")[0])
    with pytest.raises(TypeError, match="EnvMesh"):
        Tt.make_train(cfg, mesh=object())


def test_w1_mesh_step_equals_unsharded(monkeypatch):
    """A mesh of one rank from the same keys and permutations: the init,
    the trajectory, the final state and the episode counts equal the
    unsharded step's bit for bit; the parameters differ only by the
    moment formula (ngx's mesh form against adv.std()), within
    test_torch_ppo.py's tolerance.  The mesh draws its permutations from
    ``fold_in(k_upd, 0)``, so both take the unsharded step's here."""
    cfg = Tt.PPOConfig(**CFG)
    k_upd = TF.split(TF.key(4))[1]
    perms = Tt.epoch_perms(cfg, k_upd, T * B, "cpu")
    monkeypatch.setattr(Tt, "epoch_perms", lambda *a: perms)
    steps = []
    for mesh in (None, P.make_env_mesh(device="cpu")):
        init, step = Tt.make_train(cfg, mesh, rollout_backend="pallas",
                                   device="cpu")
        step.keep_rollout = True
        carry, m = step(init(3), 4)
        assert step.perms is perms
        steps.append((carry, m, step.rollout))
    (cu, mu, ru), (cm, mm, rm) = steps
    for k in FIELDS:
        assert torch.equal(getattr(cu[1], k), getattr(cm[1], k)), k
    assert torch.equal(cu[2], cm[2]) and torch.equal(cu[3], cm[3])
    for a, b in zip(ru, rm):
        assert torch.equal(a, b)
    for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum",
              "mean_reward"):
        assert float(mu[k]) == float(mm[k]), k
    for a, b in zip(cu[0].model.parameters(), cm[0].model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_train_over_a_mesh_and_dryrun():
    """train(..., mesh=...) as ngx's (ngx/rl/train.py:533), and dryrun(2):
    two gloo ranks, one step through each acting backend."""
    cfg = Tt.PPOConfig(num_envs=128, rollout_steps=4, num_minibatches=2,
                       epochs=1, hidden=(16, 16))
    _, history = Tt.train(cfg, 2, seed=1, mesh=P.make_env_mesh(device="cpu"),
                          log_every=1, rollout_backend="pallas")
    assert len(history) == 2
    assert sorted(history[0]) == sorted(history[1]) == [
        "entropy", "ep_count", "ep_len_sum", "ep_return_sum", "ep_solved",
        "episodes", "mean_reward", "pg_loss", "v_loss"]
    out = Tt.dryrun(2, device="cpu", timeout=SPAWN_TIMEOUT)
    assert sorted(out) == ["pallas", "xla"]
    for m in out.values():
        assert all(np.isfinite(v) for v in m.values()), m
