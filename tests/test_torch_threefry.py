"""The port's jax.random (ngx_torch/ops/threefry.py) bit for bit against
jax.random on the CPU: the same keys (numpy-seeded seeds, the int32 edges
among them) through ``jax.vmap`` of each jax.random function and through
the port's batched counterpart."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngx_torch.ops import threefry as TF

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

N_KEYS = 96
SHAPES = ((), (5,), (3, 7), (10, 10), (4, 10, 10))
TINY = np.finfo(np.float32).tiny


def _keys(n=N_KEYS, seed=0):
    """``n`` keys from int32 seeds (the edges first): jax's and the
    port's."""
    seeds = np.concatenate([
        np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31], np.int64),
        np.random.RandomState(seed).randint(-2 ** 31, 2 ** 31, n - 5)])
    kj = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.int32))
    kt = torch.stack([TF.key(int(s)) for s in seeds])
    return kj, kt


def _data(keys_j):
    return np.asarray(jax.random.key_data(keys_j)).astype(np.int64)


def _same(want, got, what):
    """Bit for bit: integers by value, floats by their bits."""
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype == np.float32:
        assert got.dtype == np.float32, what
        n = int((want.view(np.int32) != got.view(np.int32)).sum())
    else:
        n = int((want.astype(np.int64) != got.astype(np.int64)).sum())
    assert n == 0, f"{what}: {n} of {want.size} values differ from jax's"


def test_jax_follows_the_partitionable_scheme():
    assert jax.config.jax_threefry_partitionable, (
        "ngx_torch.ops.threefry follows jax's partitionable threefry "
        "(split, fold_in and bits hash an iota of counter pairs); this jax "
        "runs the original scheme, so its keys differ from the port's")


def test_threefry2x32_known_answers():
    """The Random123 known-answer vectors of Threefry-2x32-20, as in jax's
    own tests."""
    cases = (((0x00000000, 0x00000000), (0x00000000, 0x00000000),
              (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0)))
    for (k1, k2), (x1, x2), want in cases:
        got = TF.threefry2x32(*(torch.tensor(v, dtype=torch.int64)
                                for v in (k1, k2, x1, x2)))
        assert tuple(int(g) for g in got) == want


def test_key_split_fold_in():
    kj, kt = _keys()
    _same(_data(kj), kt, "key")
    for num in (2, 7, 13):
        _same(_data(jax.vmap(lambda k: jax.random.split(k, num))(kj)),
              TF.split(kt, num), f"split {num}")
    for data in (0, 3, 2 ** 31, 2 ** 32 - 1):
        _same(_data(jax.vmap(lambda k: jax.random.fold_in(k, data))(kj)),
              TF.fold_in(kt, data), f"fold_in {data}")
    # a batch of keys with two leading dimensions, and split twice
    k2j = jax.vmap(lambda k: jax.random.split(k, 3))(kj)
    _same(_data(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(k2j)),
          TF.split(TF.split(kt, 3), 4), "split of a [K, 3] batch")
    # seeds past int32 keep their low 32 bits
    for seed in (2 ** 32 + 3, 2 ** 31):
        _same(_data(jax.random.key(seed)), TF.key(seed), f"key {seed}")


# uniform's bounds: ngx's [0, 1) and [tiny, 1) (Gumbel's), and others
UNIFORM_BOUNDS = ((0.0, 1.0), (TINY, 1.0), (-3.0, 5.5), (0.1, 0.7))
BERNOULLI_P = (0.5, 0.1, 0.9)
# spans of 1, 2 and 2^31 - 1, the whole int32 range, empty and reversed
# ranges (span 1: minval), a span past 2^16 (the multiplier wraps to 0)
# and small ones as ngx's reset draws them
BOUNDS = ((0, 1), (0, 2), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
          (3, 3), (5, 2), (0, 65537), (0, 36), (-7, 100), (5, 20))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_randint(shape):
    """Each draw of one shape, all in one jitted ``jax.vmap``."""
    kj, kt = _keys()

    def draws(k):
        out = {"bits": jax.random.bits(k, shape)}
        for lo, hi in UNIFORM_BOUNDS:
            out[f"uniform [{lo}, {hi})"] = jax.random.uniform(
                k, shape, minval=lo, maxval=hi)
        for p in BERNOULLI_P:
            out[f"bernoulli {p}"] = jax.random.bernoulli(k, p, shape)
        for lo, hi in BOUNDS:
            out[f"randint [{lo}, {hi})"] = jax.random.randint(k, shape, lo,
                                                              hi)
        return out

    want = jax.jit(jax.vmap(draws))(kj)
    _same(want["bits"], TF.bits(kt, shape), "bits")
    for lo, hi in UNIFORM_BOUNDS:
        what = f"uniform [{lo}, {hi})"
        _same(want[what], TF.uniform(kt, shape, lo, hi), what)
    for p in BERNOULLI_P:
        _same(want[f"bernoulli {p}"], TF.bernoulli(kt, p, shape),
              f"bernoulli {p}")
    for lo, hi in BOUNDS:
        what = f"randint [{lo}, {hi})"
        _same(want[what], TF.randint(kt, shape, lo, hi), what)


def test_randint_per_element_bounds():
    """``[I]`` bounds, as ngx's random start inventory passes them
    (``ngx/core/reset.py:126``)."""
    kj, kt = _keys()
    rs = np.random.RandomState(3)
    lo = rs.randint(0, 5, 12).astype(np.int32)
    hi = (lo + rs.randint(0, 9, 12)).astype(np.int32)
    hi[:2] = lo[:2]                              # span 1 where hi <= lo
    _same(jax.jit(jax.vmap(lambda k: jax.random.randint(
        k, (12,), lo, hi)))(kj), TF.randint(kt, (12,), lo, hi),
        "randint [I] bounds")
    _same(jax.jit(jax.vmap(lambda k: jax.random.randint(
        k, (12,), jnp.asarray(lo), jnp.asarray(hi) + 1)))(kj),
        TF.randint(kt, (12,), torch.as_tensor(lo),
                   torch.as_tensor(hi) + 1), "randint [I] tensor bounds")
    with pytest.raises(ValueError, match="int32"):
        TF.randint(kt, (), 0, 2 ** 31)


@pytest.mark.parametrize("n_cells,free", [(100, 0.5), (100, 0.03), (400, 0.1),
                                          (400, 0.0), (400, 1.0)])
def test_categorical_over_masks(n_cells, free):
    """0 / ``-inf`` logits, as every draw of ngx's reset: over the free
    cells of a 10x10 map (100) and Pogostick-v0's four tap planes (400),
    rows with no free cell included (index 0, as jnp.argmax)."""
    kj, kt = _keys(256, seed=n_cells + int(free * 100))
    rs = np.random.RandomState(n_cells)
    mask = rs.rand(256, n_cells) < free
    mask[:4] = False
    logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(kj, logits))
    got = TF.categorical(kt, torch.as_tensor(logits))
    _same(want, got, "categorical over a 0/-inf mask")


def test_categorical_over_logits():
    """Finite logits, one draw per row of ``[K, 4, 30]``: the count of
    argmax flips against jax (a last-bit difference of ``log`` at a
    near-tie) is 0 on these inputs."""
    kj, kt = _keys()
    logits = np.random.RandomState(5).randn(N_KEYS, 4, 30).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(kj, logits))
    _same(want, TF.categorical(kt, torch.as_tensor(logits)),
          "categorical over finite logits")


def test_gumbel_orders_every_uniform_as_xla_does():
    """Over all 2^23 uniforms of ``uniform(tiny, 1)``, torch's and XLA's
    ``-log(-log(u))`` are both strictly increasing in ``u``: an argmax over
    a 0 / ``-inf`` mask picks the first cell of maximal ``u`` on both, so
    ngx's placements and taps are exact whatever the last bit of ``log``.
    The Gumbel values themselves differ from XLA's on some inputs (the
    count is printed), as XLA's own differ between its backends."""
    k = np.arange(2 ** 23, dtype=np.int64)
    u = ((k | 0x3F800000).astype(np.int32).view(np.float32)
         - np.float32(1)) + np.float32(TINY)
    u = np.maximum(np.float32(TINY), u).astype(np.float32)
    g_j = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u))
    g_t = (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()
    for name, g in (("XLA", g_j), ("torch", g_t)):
        assert (np.diff(g.astype(np.float64)) > 0).all(), name
    kj, kt = _keys()
    gj = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.gumbel(
        k, (10, 10))))(kj))
    gt = TF.gumbel(kt, (10, 10)).numpy()
    # gumbel is the same function of the same uniforms
    np.testing.assert_array_equal(
        gt, (-torch.log(-torch.log(TF.uniform(kt, (10, 10), TINY,
                                              1.0)))).numpy())
    print(f"gumbel: {int((gj != gt).sum())} of {gj.size} values differ from "
          f"XLA's in the last bits; on all 2^23 uniforms "
          f"{int((g_j != g_t).sum())}")
