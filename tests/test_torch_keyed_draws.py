"""The samplers the trainer draws on ngx's keys (ngx_torch/ops/threefry.py
``permutation``, ``truncated_normal``, ``erf_inv``, ``split_at``), the
flax init (``ActorCritic.from_key``) and the epochs' orders
(``ngx_torch.rl.train.epoch_perms``) against jax.random and flax on the
CPU, from the same keys.

``permutation`` and the orders are bit for bit.  ``truncated_normal`` is
held within ``TRUNC_ULP`` units in the last place of jax's, the spread
``PERF.md`` states: its ``erf_inv`` is XLA's polynomial with each Horner
step one fused multiply-add (exact against jax given jax's ``log1p``), and
torch's float32 ``log1p`` differs from XLA's in the last bit on about 9%
of inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core.scope import _fold_in_static

from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import train as Tt
from ngx_torch.rl.models import ActorCritic, flax_param_key

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

TRUNC_ULP = 3       # PERF.md: truncated_normal and from_key against jax
ERFINV_ULP = 2


def _data(k):
    return torch.as_tensor(np.array(jax.random.key_data(k)),
                           dtype=torch.int64)


def _keys(n=32, seed=0):
    seeds = np.concatenate([[0, 1, -1, 2 ** 31 - 1],
                            np.random.RandomState(seed).randint(
                                -2 ** 31, 2 ** 31, n - 4)])
    kj = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.int32))
    return kj, torch.stack([TF.key(int(s)) for s in seeds])


def _ulp(want, got):
    """Units in the last place between two float32 arrays of one sign
    pattern (as int32 bit patterns)."""
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 512, 524288])
def test_permutation_matches_jax(n):
    """``permutation(key, n)`` bit for bit (int32) for three keys, and for
    a batch of six (``jax.vmap``'s); at n = 524,288 (T 64 x B 8,192, two
    rounds) the first round's sort keys tie, so the sort's stability is on
    the path."""
    for seed in (0, 7, -3):
        want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
        got = TF.permutation(TF.key(seed), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # a batch of keys is jax.vmap's: one row per key
    kj, kt = _keys(6)
    np.testing.assert_array_equal(
        TF.permutation(kt, n).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(kj)))
    if n == 524288:
        _, sub = TF.split(TF.key(0))
        ties = n - torch.unique(TF.bits(sub, (n,))).numel()
        assert ties > 0, "no tied sort keys: stability is not exercised"


def test_split_at_and_as_key():
    """``split_at(key, idx)`` is rows ``idx`` of ``split(key, n)`` (any n
    past them), batched over keys; ``as_key`` takes an int or a key."""
    k = TF.key(9)
    idx = torch.tensor([0, 5, 3, 1023])
    np.testing.assert_array_equal(TF.split_at(k, idx).numpy(),
                                  TF.split(k, 1024)[idx].numpy())
    ks = TF.split(k, 3)
    np.testing.assert_array_equal(TF.split_at(ks, idx).numpy(),
                                  TF.split(ks, 1024)[:, idx].numpy())
    np.testing.assert_array_equal(TF.split_at(k, idx).numpy(), np.asarray(
        jax.random.key_data(jax.random.split(jax.random.key(9), 1024)))[
            idx.numpy()])
    assert torch.equal(TF.as_key(9), k) and torch.equal(TF.as_key(k), k)
    with pytest.raises(ValueError, match=r"\[2\]"):
        TF.as_key(ks)


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0), (0.0, 1.0)])
def test_truncated_normal_within_ulp_of_jax(bounds):
    """32 keys x (64, 64) draws (the lecun bounds and two others whose
    ``erf`` torch rounds as XLA does) within ``TRUNC_ULP`` of jax's; about
    1% differ at all."""
    lo, hi = bounds
    kj, kt = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.truncated_normal(
        k, lo, hi, (64, 64)))(kj))
    got = TF.truncated_normal(kt, lo, hi, (64, 64)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    d = _ulp(want, got)
    assert int(d.max()) <= TRUNC_ULP, int(d.max())
    assert (d > 0).mean() < 0.02
    assert (got > lo).all() and (got < hi).all()


def test_erf_inv_is_xlas_polynomial():
    """``erf_inv`` within ``ERFINV_ULP`` of ``lax.erf_inv`` over a million
    float32 uniforms of the lecun range, exact where jax's ``log1p`` is
    given to it, and ``±inf`` at ``±1``; ``torch.special.erfinv`` is
    further off on most inputs."""
    u = np.random.RandomState(0).uniform(-0.9545, 0.9545,
                                         1_000_000).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    d = _ulp(want, TF.erf_inv(torch.as_tensor(u)).numpy())
    assert int(d.max()) <= ERFINV_ULP
    torch_d = _ulp(want, torch.special.erfinv(torch.as_tensor(u)).numpy())
    assert (torch_d > 0).sum() > 10 * (d > 0).sum()
    ends = TF.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    assert ends[0] == -np.inf and ends[1] == np.inf


def test_flax_param_key_is_flaxs():
    """The per-layer key of ``from_key`` is flax's ``LazyRng`` fold: the
    SHA-1 of ``(path, counter)`` folded into the init key."""
    k = jax.random.key(5)
    for name in ("pi_0", "v_1", "pi_out", "v_out"):
        for counter in (1, 2, 300):
            want = np.asarray(jax.random.key_data(
                _fold_in_static(k, (name, counter))))
            np.testing.assert_array_equal(
                flax_param_key(_data(k), name, counter).numpy(), want)


@pytest.mark.parametrize("hidden", [(64, 64), (16,)])
def test_from_key_matches_flax_init(hidden):
    """``ActorCritic.from_key(key, 63, 9, hidden)`` against flax's
    ``init(key, obs)`` for three keys: every kernel within ``TRUNC_ULP``
    of flax's, every bias zero, on the names' layout."""
    for seed in (0, 1, 12345):
        params = FlaxActorCritic(n_actions=9, hidden=hidden).init(
            jax.random.key(seed), jnp.zeros((1, 63)))["params"]
        model = ActorCritic.from_key(TF.key(seed), 63, 9, hidden)
        assert sorted(dict(model.named_children())) == sorted(params)
        for name, lin in model.named_children():
            w = np.asarray(params[name]["kernel"])
            got = lin.weight.detach().numpy().T.copy()
            assert got.shape == w.shape
            assert int(_ulp(w, got).max()) <= TRUNC_ULP, (seed, name)
            assert not lin.bias.detach().any()


@pytest.mark.parametrize("shuffle", ["permutation", "affine"])
def test_epoch_perms_match_ngx(shuffle):
    """ngx's update orders (``ngx/rl/train.py:162-176``, ``:196``) from
    one key, two epochs over 4,096 samples, bit for bit; the affine
    shuffle refuses a batch that is not a power of two, as ngx's asserts."""
    cfg = Tt.PPOConfig(epochs=2, shuffle=shuffle)
    key, n = jax.random.key(8), 4096
    want = []
    for k in jax.random.split(key, cfg.epochs):
        if shuffle == "affine":
            a = jax.random.randint(k, (), 0, n // 2) * 2 + 1
            r = jax.random.randint(jax.random.fold_in(k, 1), (), 0, n)
            want.append(np.asarray((jnp.arange(n) * a + r) % n))
        else:
            want.append(np.asarray(jax.random.permutation(k, n)))
    got = Tt.epoch_perms(cfg, TF.key(8), n, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if shuffle == "affine":
        with pytest.raises(ValueError, match="power-of-two"):
            Tt.epoch_perms(cfg, TF.key(8), 3000, "cpu")
