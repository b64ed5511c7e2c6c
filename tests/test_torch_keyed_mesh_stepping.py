"""The mesh's stepping functions and the scaling harness on ngx's keys
(ngx_torch/parallel ``sharded_throughput_fn`` / ``make_spmd_rollout`` with
``rng='threefry'``, ngx_torch/rl/scaling.py ``_scaling_rank``) against ngx
from the same ``jax.random`` key on the CPU: two in-process ranks
(``make_local_meshes``) against ngx's mesh of two CPU devices, on
NovelGridworld-v3 (its wall coin is a reset edit, and random actions end
episodes there), B 256, T 32.

Bit for bit: each rank's final state rows, and the done counts exactly.
The mean reward within rtol 1e-6 of ngx's: the ranks' float32 sums are
added in another order than XLA's reduction (every v3 reward is an
integer, so here the sums are exact and the means equal)."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import ngx
import ngx.rl.train as JT
from ngx import parallel as JP
from ngx.rl.scaling import measure_scaling
import ngx_torch as nt
import ngx_torch.rl.train as Tt
from ngx_torch import parallel as P
from ngx_torch.ops import threefry as TF
from ngx_torch.rl.scaling import _scaling_rank

from test_torch_native_reset import _rows_differing

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

ENV, W, B, T = "NovelGridworld-v3", 2, 256, 32


def _on_ranks(fn):
    """``fn(mesh)`` on each of W in-process ranks (one thread each);
    returns their results in rank order."""
    out = [None] * W

    def run(mesh):
        out[mesh.rank] = fn(mesh)

    threads = [threading.Thread(target=run, args=(m,))
               for m in P.make_local_meshes(W, "cpu")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _rows(state, r):
    sl = slice(r * B // W, (r + 1) * B // W)
    return state.replace(**{f: getattr(state, f)[sl]
                            for f in state.__dataclass_fields__})


def _ngx_mesh():
    return Mesh(np.asarray(jax.devices()[:W]), ("env",))


def test_keyed_sharded_throughput_matches_ngx():
    """``sharded_throughput_fn(rng='threefry')`` from ``key(7)``: each
    rank's state its rows of ngx's global state, the episode count ngx's,
    the mean reward within rtol 1e-6, one all-reduce; an int is
    ``key(int)``."""
    state_j, mean_j, done_j = JP.sharded_throughput_fn(
        ngx.make_spec(ENV), _ngx_mesh(), B, T)(jax.random.key(7))

    def rank(mesh, key):
        out = P.sharded_throughput_fn(nt.make_spec(ENV), mesh, B, T,
                                      rng="threefry")(key)
        return out + (list(mesh.log),)

    out = _on_ranks(lambda m: rank(m, TF.key(7)))
    assert int(done_j) > 0
    for r, (state, mean, done, log) in enumerate(out):
        n_bad, fields = _rows_differing(_rows(state_j, r), state)
        assert n_bad == 0, f"rank {r}: {n_bad} envs differ in {fields}"
        assert int(done) == int(done_j)
        np.testing.assert_allclose(float(mean), float(mean_j), rtol=1e-6)
        assert log == [("all_reduce", "metrics", 16)]
    again = _on_ranks(lambda m: rank(m, 7))
    for (state, *_), (state2, *_) in zip(out, again):
        assert _rows_differing(state, state2)[0] == 0


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_keyed_spmd_rollout_matches_ngx(packed):
    """``make_spmd_rollout(rng='threefry')`` from ``key(9)``, each rank its
    own scan from ``fold_in(<its first key>, 17)``: the episode count
    ngx's, the mean reward within rtol 1e-6, on every rank; packed or not,
    the same bits."""
    mean_j, done_j = JP.make_spmd_rollout(
        ngx.make_spec(ENV), _ngx_mesh(), B, T, packed=packed)(
            jax.random.key(9))
    out = _on_ranks(lambda m: P.make_spmd_rollout(
        nt.make_spec(ENV), m, B, T, packed=packed, rng="threefry")(
            TF.key(9)))
    assert int(done_j) > 0
    for mean, done in out:
        assert int(done) == int(done_j)
        np.testing.assert_allclose(float(mean), float(mean_j), rtol=1e-6)
    if packed:
        plain = _on_ranks(lambda m: P.make_spmd_rollout(
            nt.make_spec(ENV), m, B, T, rng="threefry")(TF.key(9)))
        assert [(float(a), int(b)) for a, b in out] == \
            [(float(a), int(b)) for a, b in plain]


def test_keyed_stepping_refuses_an_unknown_rng():
    mesh = P.make_local_meshes(1, "cpu")[0]
    for make in (P.sharded_throughput_fn, P.make_spmd_rollout):
        with pytest.raises(ValueError, match="rng"):
            make(nt.make_spec(ENV), mesh, 128, 4, rng="philox")


def test_scaling_rank_draws_ngx_keys(monkeypatch):
    """``_scaling_rank`` builds ``make_train(cfg, mesh)`` on ngx's keys,
    inits on ``key(0)``, warms up on ``fold_in(key, 1)`` and times step
    ``r`` on ``fold_in(key, 2 + r)``: the keys ngx's ``measure_scaling``
    hands its trainer (both recorded by a stand-in trainer)."""
    seen_j, seen_t = [], []

    def fake_j(cfg, mesh, **kw):
        def init(key):
            seen_j.append(np.asarray(jax.random.key_data(key)))
            return jnp.zeros(())

        def step(carry, key):
            jax.debug.callback(lambda k: seen_j.append(np.asarray(k)),
                               jax.random.key_data(key), ordered=True)
            return carry, {"mean_reward": carry}
        return init, step

    def fake_t(cfg, mesh, **kw):
        assert kw == {} and mesh is not None

        def init(key):
            seen_t.append(key.numpy())
            return 0

        def step(carry, key):
            seen_t.append(key.numpy())
            return carry, {"mean_reward": torch.zeros(())}
        return init, step

    monkeypatch.setattr(JT, "make_train", fake_j)
    monkeypatch.setattr(Tt, "make_train", fake_t)
    measure_scaling((1,), per_device_batch=128, rollout_steps=4, repeats=2)
    jax.effects_barrier()
    _scaling_rank(P.make_local_meshes(1, "cpu")[0],
                  dict(num_envs=128, rollout_steps=4), 2)
    assert len(seen_t) == len(seen_j) == 4
    for got, want in zip(seen_t, seen_j):
        np.testing.assert_array_equal(got, want.astype(np.int64))
