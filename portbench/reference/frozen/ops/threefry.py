"""jax.random's default PRNG (threefry2x32, partitionable) in plain torch.

ngx draws every reset, action and permutation with ``jax.random`` keys
(jax 0.9.0's default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``).  Threefry and the samplers ngx builds on
it are integer and float32 arithmetic, so the same key gives the same bits
here, on the CPU and on the card, as in ngx.  The names follow
``jax.random``:

* :func:`key` — ``threefry_seed`` (``jax/_src/prng.py:802``): the words
  ``(0, seed mod 2^32)`` (without x64 a seed is an int32 / uint32);
* :func:`split`, :func:`fold_in` — the partitionable forms
  (``prng.py:1143-1170``): sub-key ``i`` is ``threefry2x32(key, (i >> 32,
  i & M))``, so ``fold_in(key, j) == split(key, n)[j]``;
* :func:`bits` — ``_threefry_random_bits_partitionable`` (``prng.py:1184``):
  element ``i`` of the row-major flattened shape hashes the counter pair
  ``(i >> 32, i & M)`` and xors the two output words;
* :func:`uniform` (``jax/_src/random.py:435``), :func:`randint` (``:581``),
  :func:`bernoulli` (``:1028``, mode ``'low'``), :func:`gumbel` (``:1723``,
  mode ``'low'``) and :func:`categorical` (``:1739``, with replacement, over
  the last axis).

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of
``jax.random.key_data``.  Every function takes a batch of keys: the leading
``K`` dimensions of ``keys[*K, 2]`` are ``jax.vmap``'s axis, so
``bits(keys, shape)`` is ``[*K, *shape]`` and equals
``jax.vmap(lambda k: jax.random.bits(k, shape))`` on the same keys.

Parity hazard — uint32 arithmetic: the torch CPU build has no ``>>`` or
``%`` on ``uint32``, so every word is an int64 tensor holding a value in
``[0, 2^32)``, masked after each add, shift and multiply; each value stays
non-negative before a right shift.  ``randint``'s product of two words is
formed in 16-bit halves so that no int64 product overflows.

Parity hazard — float32 ``log``: :func:`gumbel` is ``-log(-log(u))`` in
float32, and torch's ``log`` (on the CPU or the card) differs from XLA's in
the last bit on some inputs (about a quarter of Gumbel values differ from
XLA's on the CPU), as XLA's own ``log`` differs between its backends.
:func:`categorical` over a 0 / ``-inf`` mask (every draw of ngx's reset) is
exact all the same: over all 2^23 uniforms this sampler can produce, both
torch's and XLA's Gumbel scores are strictly increasing in ``u``, so the
argmax is the first cell of maximal ``u`` on both (the tests check this by
exhaustion, chip_smoke on the card).  Over arbitrary logits an argmax could
flip at a near-tie; the tests count such flips.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000          # float32 1.0: exponent 0, mantissa 0
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (``prng.py:_threefry2x32_lowering``, 20
    rounds): key words ``k1, k2`` and counter words ``x1, x2``, int64
    tensors of uint32 values that broadcast together; returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def _words(keys):
    """``(k1, k2)`` of ``keys[*K, 2]``, each ``[*K]``."""
    keys = torch.as_tensor(keys).to(torch.int64)
    if keys.shape[-1:] != (2,):
        raise ValueError(f"a key batch is [..., 2], got {tuple(keys.shape)}")
    return keys[..., 0], keys[..., 1]


def _counters(shape, device):
    """The counter words of a flattened row-major ``shape``:
    ``(i >> 32, i & M)`` for element ``i`` (``prng.py:989``)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return i >> 32, i & M32


def _hash(keys, shape):
    """``threefry2x32(key, counters(shape))`` per key: two words
    ``[*K, *shape]``."""
    k1, k2 = _words(keys)
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, k1.device)
    view = k1.shape + (1,) * len(shape)
    return threefry2x32(k1.reshape(view), k2.reshape(view), hi, lo)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: int64 ``[2]``,
    ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def as_key(k, device="cpu") -> torch.Tensor:
    """One key as an int64 ``[2]`` tensor on ``device`` (the host by
    default, where a trainer derives its scalar seeds without a device
    read): a key tensor or array as it is, an int as ``key(int)``."""
    if isinstance(k, (int, np.integer)):
        return key(int(k), device)
    k = torch.as_tensor(k)
    if k.shape != (2,):
        raise ValueError(f"a key is [2], got {tuple(k.shape)}")
    return k.to(device=device, dtype=torch.int64)


def split(keys, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` per key: ``[*K, num, 2]``."""
    y1, y2 = _hash(keys, (num,))
    return torch.stack([y1, y2], dim=-1)


def split_at(keys, index) -> torch.Tensor:
    """Rows ``index`` of ``split(keys, n)`` for any ``n`` past the largest
    index, without the others: sub-key ``i`` hashes the counter pair ``(i
    >> 32, i & M)`` alone.  ``index``: an integer tensor ``[*I]`` on the
    keys' device; gives ``[*K, *I, 2]``."""
    k1, k2 = _words(keys)
    i = torch.as_tensor(index).to(device=k1.device, dtype=torch.int64)
    view = k1.shape + (1,) * i.dim()
    y1, y2 = threefry2x32(k1.reshape(view), k2.reshape(view), i >> 32,
                          i & M32)
    return torch.stack([y1, y2], dim=-1)


def fold_in(keys, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` per key: ``[*K, 2]`` (``data`` as
    its uint32 bits)."""
    k1, k2 = _words(keys)
    zero = torch.zeros((), dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1, k2, zero, zero + (int(data) & M32))
    return torch.stack([y1, y2], dim=-1)


def bits(keys, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) per key: int64
    ``[*K, *shape]`` of values in ``[0, 2^32)``."""
    y1, y2 = _hash(keys, shape)
    return y1 ^ y2


def uniform(keys, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled,
    shifted and clamped below at ``minval``.

    XLA contracts jax's ``floats * (maxval - minval) + minval`` into one
    fused multiply-add, so the scale and shift here are one float64
    product (exact: 23 by 24 bits) and sum, rounded once to float32.  On
    ngx's bounds, [0, 1) and [tiny, 1), the product is exact in float32
    too; on others the unfused float32 form differs from XLA's in the last
    bit on about half the draws (the tests hold this form bit for bit)."""
    b = (bits(keys, shape) >> 9) | _ONE_F32_BITS
    floats = b.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=floats.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def _mulmod32(a, b):
    """``(a * b) mod 2^32`` for uint32 values in int64, with no int64
    product past 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _bound(v, device):
    """A randint bound as int64 on ``device``; host values are checked to
    lie within int32 (a device tensor is taken as it is, without a sync)."""
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v, dtype=np.int64)
        if ((a < -2 ** 31) | (a >= 2 ** 31)).any():
            raise ValueError(f"randint bound {v!r} lies outside int32")
        v = torch.from_numpy(a)
    return v.to(device=device, dtype=torch.int64)


def randint(keys, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) per key.

    ``minval`` / ``maxval``: ints or integer tensors that broadcast against
    ``shape`` (per-element bounds), within int32.  Two draws of 32 bits,
    ``higher`` from ``split(key)[0]`` and ``lower`` from ``[1]``, reduced
    modulo ``span = maxval - minval`` (1 where ``maxval <= minval``) as
    ``((higher % span) * m + lower % span) % span`` with ``m = ((2^16 %
    span)^2 mod 2^32) % span``, every product and sum wrapping in uint32 as
    jax's does (so ``m`` is 0 where ``span`` exceeds 2^16)."""
    sub = split(keys, 2)
    higher, lower = bits(sub[..., 0, :], shape), bits(sub[..., 1, :], shape)
    lo, hi = (_bound(v, higher.device) for v in (minval, maxval))
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & M32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (_mulmod32(higher % span, mult) + lower % span) & M32
    out = lo + off % span
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def bernoulli(keys, p=0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``'low'``) per key:
    ``uniform(key, shape) < p`` in float32."""
    u = uniform(keys, shape)
    return u < torch.as_tensor(p, dtype=torch.float32, device=u.device)


def gumbel(keys, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (mode ``'low'``) per key:
    ``-log(-log(u))`` with ``u = uniform(key, shape, tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY_F32, 1.0)))


def categorical(keys, logits) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement, per key: ``keys[*K, 2]`` and float32 ``logits[*K, *S, N]``
    give int64 ``[*K, *S]``, the first index of ``argmax(gumbel(key,
    (*S, N)) + logits)``."""
    logits = torch.as_tensor(logits)
    nk = torch.as_tensor(keys).dim() - 1
    g = gumbel(keys, tuple(logits.shape[nk:]))
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def permutation(keys, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int32 ``[*K, n]``) per key of
    ``keys[*K, 2]``: jax's ``_shuffle`` (``jax/_src/random.py:700``),
    ``ceil(3 ln(n) / ln(2^32 - 1))`` rounds, each ``key, sub = split(key)``
    and a stable sort of the values by ``bits(sub, (n,))``; a batch of keys
    sorts in one call a round.

    Parity hazard — ties: the 32-bit sort keys collide (about ``n^2 /
    2^33`` pairs a round, some 32 at n = 524,288), and ``lax.sort_key_val``
    is stable, so the sort here is ``torch.sort(stable=True)`` over the
    words widened to int64 (the card's torch may not sort uint32)."""
    k1, _ = _words(keys)
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=k1.device).expand(
        k1.shape + (n,))
    sub = torch.as_tensor(keys).to(torch.int64)
    for _ in range(rounds):
        pair = split(sub)
        sub = pair[..., 0, :]
        order = torch.sort(bits(pair[..., 1, :], (n,)), dim=-1,
                           stable=True).indices
        x = x.gather(-1, order)
    return x.to(torch.int32)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"):
# Horner coefficients, highest degree first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma32(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32, as XLA
    contracts it (the float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` on float32, XLA's polynomial (not
    ``torch.special.erfinv``, which differs from it in the last bits on
    most inputs): ``w = -log1p(-x^2)``; ``w - 2.5`` below 5, else
    ``sqrt(w) - 3``; a degree-8 Horner polynomial in ``w`` (each step one
    fused multiply-add) times ``x``; ``±inf`` at ``|x| = 1``."""
    x = x.to(torch.float32)
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def truncated_normal(keys, lower, upper, shape=()) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` (float32)
    per key (``random.py:1005``): ``u = uniform(key, shape, erf(lower /
    sqrt2), erf(upper / sqrt2))``, then ``sqrt2 * erf_inv(u)`` clamped into
    ``(nextafter(lower, inf), nextafter(upper, -inf))``.  ``erf_inv`` is
    XLA's (:func:`erf_inv`); ``log1p`` and ``erf`` are torch's, whose
    float32 results may differ from XLA's in the last bit (the tests state
    the ulp spread against jax)."""
    dev = torch.as_tensor(keys).device
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=dev)
    lo = torch.tensor(lower, dtype=torch.float32, device=dev)
    hi = torch.tensor(upper, dtype=torch.float32, device=dev)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    u = uniform(keys, shape, a, b)
    out = sqrt2 * erf_inv(u)
    inf = torch.tensor(float("inf"), device=dev)
    return torch.clamp(out, torch.nextafter(lo, inf),
                       torch.nextafter(hi, -inf))
