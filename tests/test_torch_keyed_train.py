"""The port's PPO trainer on ngx's keys (``make_train``,
ngx_torch/rl/train.py) against ngx's ``make_train`` from the same
``jax.random`` key on the CPU: B 128, T 8, hidden (16, 16), cap 5, two
steps, on both acting backends ('xla', the unfused loop, and the kernel:
ngx's 'pallas' interpreted, the port's twin), native resets
(Pogostick-v1) and pool resets (fence medium); and the mesh at W 2 through
the port's in-process twin against ngx's two-device mesh.

Bit for bit: the init's state and obs, each step's kernel and pool seeds
(derived here from the key as ngx derives them inside its jit) and its
epoch permutations, the state and obs after each step, and the episode
counts.  The parameters: the init's within the ulp spread of
``truncated_normal`` (``PERF.md``), and after each update at
tests/test_torch_ppo.py's rtol 1e-5 / atol 1e-6 (the MLP and Adam round
in another order than XLA's)."""

import copy
import threading

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from ngx.rl import train as J
from ngx_torch import parallel as P
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import train as Tt

from test_torch_native_reset import _rows_differing, _specs

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
FENCE = (("fence", "medium", "oak"),)
CFG = dict(num_envs=128, rollout_steps=8, num_minibatches=2, epochs=2,
           hidden=(16, 16), episode_cap=5)
STEPS = 2
I32_MAX = 2 ** 31 - 1
INIT_ULP = 3        # the truncated_normal spread against jax (PERF.md)


def _key_data(k):
    return torch.as_tensor(np.array(jax.random.key_data(k)),
                           dtype=torch.int64)


def ngx_draws(cfg, key, pool, n, rank=None):
    """ngx's seeds and permutations of the step keyed ``key``, derived as
    ngx's jitted step derives them (``ngx/rl/train.py:391-412``,
    ``:157-199``, ``:445-449``)."""
    k_roll, k_upd = jax.random.split(key)
    seeds = (None, None)
    if pool:
        k_seed, k_pool = jax.random.split(k_roll)
        seeds = (int(jax.random.randint(k_seed, (), 0, I32_MAX)),
                 int(jax.random.randint(k_pool, (), 0, I32_MAX)))
    else:
        seeds = (int(jax.random.randint(k_roll, (), 0, I32_MAX)), None)
    if rank is not None:
        k_upd = jax.random.fold_in(k_upd, rank)
    perms = [np.asarray(jax.random.permutation(k, n))
             for k in jax.random.split(k_upd, cfg.epochs)]
    return seeds, perms


def _params_close(model, params_j, what, ulp=None):
    pj = params_j["params"]
    for name, lin in model.named_children():
        w, b = np.asarray(pj[name]["kernel"]), np.asarray(pj[name]["bias"])
        got_w = lin.weight.detach().numpy().T.copy()
        if ulp is not None:
            d = np.abs(w.view(np.int32).astype(np.int64)
                       - got_w.view(np.int32).astype(np.int64))
            assert int(d.max()) <= ulp, f"{what}: {name} {int(d.max())} ulp"
            np.testing.assert_array_equal(lin.bias.detach().numpy(), b)
        else:
            np.testing.assert_allclose(got_w, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {name}")
            np.testing.assert_allclose(lin.bias.detach().numpy(), b,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {name}")


def _metrics_match(m_t, m_j, what):
    m_j = {k: float(v) for k, v in m_j.items()}
    assert sorted(m_t) == sorted(m_j)
    for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum",
              "ep_return_sum", "mean_reward"):
        assert float(m_t[k]) == m_j[k], (what, k)
    for k in ("v_loss", "entropy"):
        np.testing.assert_allclose(float(m_t[k]), m_j[k], rtol=1e-5,
                                   err_msg=f"{what}: {k}")
    np.testing.assert_allclose(float(m_t["pg_loss"]), m_j["pg_loss"],
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("novs", [(), FENCE], ids=["native", "pool"])
def test_keyed_train_matches_ngx(backend, novs):
    """Two keyed steps from ``key(0)``, step ``u`` on ``fold_in(key, u +
    1)`` as ngx's ``train`` feeds them."""
    spj, spt = _specs(POGO, novs)
    cfg_j, cfg_t = J.PPOConfig(**CFG), Tt.PPOConfig(**CFG)
    init_j, step_j = J.make_train(cfg_j, spec_override=spj,
                                  rollout_backend=backend)
    init_t, step_t = Tt.make_train(cfg_t, spec_override=spt,
                                   rollout_backend=backend, device="cpu")
    pool = backend == "pallas" and bool(novs)
    assert step_t.reset_source == (
        "vec" if backend == "xla" else "pool" if pool else "native")
    key = jax.random.key(0)
    carry_j = init_j(key)
    carry_t = init_t(TF.key(0))
    assert _rows_differing(carry_j[1], carry_t[1])[0] == 0
    np.testing.assert_array_equal(carry_t[2].numpy(),
                                  np.asarray(carry_j[2], np.float32))
    _params_close(carry_t[0].model, carry_j[0].params, "init", INIT_ULP)
    run_j = jax.jit(step_j)
    n = cfg_t.rollout_steps * cfg_t.num_envs
    for u in range(STEPS):
        k_u = jax.random.fold_in(key, u + 1)
        carry_j, m_j = run_j(carry_j, k_u)
        carry_t, m_t = step_t(carry_t, TF.fold_in(TF.key(0), u + 1))
        seeds, perms = ngx_draws(cfg_j, k_u, pool, n)
        what = f"{backend} step {u}"
        assert step_t.seeds == (seeds if backend == "pallas"
                                else (None, None)), what
        for got, want in zip(step_t.perms, perms):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        n_bad, fields = _rows_differing(carry_j[1], carry_t[1])
        assert n_bad == 0, f"{what}: {n_bad} envs differ in {fields}"
        np.testing.assert_array_equal(carry_t[2].numpy(),
                                      np.asarray(carry_j[2], np.float32))
        _params_close(carry_t[0].model, carry_j[0].params, what)
        _metrics_match(m_t, m_j, what)
        assert float(m_t["episodes"]) > 0          # the cap ends episodes


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_keyed_mesh_matches_ngx(backend):
    """ngx's ``make_train(cfg, mesh)`` over two CPU devices (B 256, 128 a
    device) against the port's in-process twin (two threads over
    ``make_local_meshes``) from the same key, one step: each rank's rows of
    ``split(k_env, B)`` at init, its shard seed (``+ rank * 612331``), its
    permutations from ``fold_in(k_upd, rank)``, its state rows bit for
    bit after the step, the parameters and global metrics at the
    tolerance above."""
    W = 2
    cfg = dict(CFG, num_envs=128 * W)
    spj, spt = _specs(POGO, ())
    mesh_j = Mesh(np.asarray(jax.devices()[:W]), ("env",))
    key = jax.random.key(3)
    with mesh_j:
        init_j, step_j = J.make_train(J.PPOConfig(**cfg), mesh_j,
                                      spec_override=spj,
                                      rollout_backend=backend)
        carry0 = init_j(key)
        carry_j, m_j = jax.jit(step_j)(carry0, jax.random.key(4))
    out = [None] * W

    def rank(mesh):
        init, step = Tt.make_train(Tt.PPOConfig(**cfg), mesh,
                                   spec_override=spt,
                                   rollout_backend=backend)
        c0 = init(_key_data(key))
        model0 = copy.deepcopy(c0[0].model)       # the step updates c0's
        c1, m = step(c0, _key_data(jax.random.key(4)))
        out[mesh.rank] = (c0[1], model0, c1, m, step.seeds, step.perms)

    threads = [threading.Thread(target=rank, args=(m,))
               for m in P.make_local_meshes(W, "cpu")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    n_loc = cfg["rollout_steps"] * 128
    for r, (state0, model0, c1, m, seeds, perms) in enumerate(out):
        sl = slice(r * 128, (r + 1) * 128)
        rows = lambda st: st.replace(**{          # noqa: E731
            f: getattr(st, f)[sl] for f in st.__dataclass_fields__})
        assert _rows_differing(rows(carry0[1]), state0)[0] == 0
        want_seeds, want_perms = ngx_draws(J.PPOConfig(**cfg),
                                           jax.random.key(4), False, n_loc,
                                           rank=r)
        assert seeds == (want_seeds if backend == "pallas"
                         else (None, None))
        for got, want in zip(perms, want_perms):
            np.testing.assert_array_equal(got.numpy(), want)
        n_bad, fields = _rows_differing(rows(carry_j[1]), c1[1])
        assert n_bad == 0, f"rank {r}: {n_bad} envs differ in {fields}"
        np.testing.assert_array_equal(
            c1[2].numpy(), np.asarray(carry_j[2], np.float32)[sl])
        _params_close(model0, carry0[0].params, f"rank {r} init",
                      INIT_ULP)
        _params_close(c1[0].model, carry_j[0].params, f"rank {r}")
        _metrics_match(m, m_j, f"rank {r}")


@pytest.mark.parametrize("form", ["int", "key"])
def test_keyed_train_loop_and_forms(form):
    """``train(...)`` feeds ``fold_in(key, u + 1)`` to update ``u`` (its
    first step equals a step on that key), the seed given as an int
    (``key(int)``) or as a key tensor."""
    cfg = Tt.PPOConfig(**dict(CFG, epochs=1))
    seed = 5 if form == "int" else TF.key(5)
    carry, hist = Tt.train(cfg, 1, seed=seed, log_every=1, device="cpu")
    init, step = Tt.make_train(cfg, device="cpu")
    want, m = step(init(5), TF.fold_in(TF.key(5), 1))
    assert hist[0] == {k: float(v) for k, v in m.items()}
    for f in carry[1].__dataclass_fields__:
        assert torch.equal(getattr(want[1], f), getattr(carry[1], f)), f


def test_dryrun_rank_runs_the_keyed_step():
    """A dry-run rank (``dryrun``'s body) on a mesh of one: each backend's
    metrics are those of the keyed trainer's step on ``key(1)`` from
    ``key(0)`` at 128 envs a rank."""
    mesh = P.make_env_mesh(device="cpu")
    got = Tt._dryrun_rank(mesh)
    assert sorted(got) == ["pallas", "xla"]
    for backend, m in got.items():
        cfg = Tt.PPOConfig(num_envs=128, rollout_steps=4, num_minibatches=2,
                           epochs=1, hidden=(16, 16))
        init, step = Tt.make_train(cfg, mesh, rollout_backend=backend)
        _, want = step(init(TF.key(0)), TF.key(1))
        assert m == {k: float(v) for k, v in want.items()}, backend
