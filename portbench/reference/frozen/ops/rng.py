"""The murmur3 counter RNG of ``ngx/ops/pallas_rollout.py:103-142`` as plain
torch (``_mix``, ``_bits``, ``_u01``, ``_randint``).

A hash over (seed, step counter, call-site salt, row, column): every draw of
the reset and of the acting loop is a pure function of those five numbers,
so the plain twin, the CUDA kernel and the JAX kernel consume the same bits.

Parity hazard — uint32 arithmetic: the torch CPU build has no ``>>`` or
``%`` on ``uint32``.  Every value here is an int64 tensor holding a uint32 in
[0, 2^32): each multiply, xor and add is masked with ``& 0xFFFFFFFF``.  An
int64 product wraps on overflow and keeps its low 32 bits, which are the
uint32 product's bits.  The CUDA kernel uses ``uint32_t`` natively.

Parity hazard — the stream depends on the logical block: the TPU kernel seeds
block ``blk`` with the int32 sum ``seed + blk*7919`` (wrapping,
``pallas_rollout.py:1071``) and hashes the row WITHIN the block
(``_bits``, ``:121-124``); :func:`block_streams` reproduces both for any env
index, whatever launch geometry runs it.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B1
_BLOCK_SEED_STRIDE = 7919


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mix(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    return x


def _bits(seed, ctr, salt, rows, cols):
    """uint32 hash bits, int64 ``[len(rows), len(cols)]``.

    ``seed`` and ``ctr``: Python ints (int32 values, negative ones wrap as
    in ``astype(uint32)``) or int64 tensors broadcastable against
    ``rows[:, None]``; ``rows``/``cols``: int64 index tensors (the two iota
    axes of the TPU kernel's ``_bits`` shape)."""
    salt_c = (int(salt) * 0x85EBCA77) & M32
    seed_u = _u32(seed)
    ctr_u = _u32(ctr)
    base = _mix(((seed_u * _GOLD) & M32) ^ ((ctr_u * 0x632BE59B) & M32)
                ^ salt_c)
    if isinstance(base, torch.Tensor) and base.dim() == 1:
        base = base[:, None]
    lane = ((rows[:, None] * 0x01000193) + (cols[None, :] * 0x9E3779B9)) & M32
    return _mix(_mix(lane ^ base))


def _u01(seed, ctr, salt, rows, cols):
    """24-bit mantissa uniforms in [0, 1), float32 (exact: < 2^24 before
    the power-of-two scale)."""
    return (_bits(seed, ctr, salt, rows, cols) >> 8).to(torch.float32) \
        * (2.0 ** -24)


def _randint(seed, ctr, salt, rows, cols, n):
    """Top-31-bits modulo ``n`` (int64); bias < 2^-27 for n <= 64."""
    return (_bits(seed, ctr, salt, rows, cols) >> 1) % n


def block_streams(seed: int, n: int, block: int, device=None, offset: int = 0):
    """Per-env ``(seed_env, row)`` int64 tensors for envs ``offset ..
    offset+n-1`` cut into RNG blocks of ``block`` envs: ``seed_env = seed +
    blk*7919`` (int32 wrap, carried as its uint32 bits) and ``row = env %
    block``.  ``offset`` is a shard's first global env (:mod:`ngx_torch.
    parallel`), so a shard draws the global batch's streams."""
    env = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    blk = env // block
    return (int(seed) + blk * _BLOCK_SEED_STRIDE) & M32, env % block
