// jax.random's threefry2x32 (partitionable; ngx_torch/ops/threefry.py, the
// plain twin) as native uint32 arithmetic: the device code that draws on
// ngx's keys, shared by native_reset.cuh and categorical.cu.  The functions
// are __host__ __device__, so g++ builds them for the host in the tests.

#pragma once

#include "ngx_env.cuh"

struct TfKey {
  uint32_t a, b;
};

NGX_HD uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// The Threefry-2x32 block, 20 rounds (prng.py _threefry2x32_lowering).
NGX_HD TfKey threefry2x32(TfKey k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl32(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return TfKey{x1, x2};
}

// Sub-key i of split(k, n) for any n past i, and fold_in(k, i): the counter
// pair (i >> 32, i & M).
NGX_HD TfKey tf_child(TfKey k, unsigned long long i) {
  return threefry2x32(k, (uint32_t)(i >> 32), (uint32_t)i);
}

// Element i (row-major) of bits(k, shape).
NGX_HD uint32_t tf_bits(TfKey k, uint32_t i) {
  const TfKey y = threefry2x32(k, 0u, i);
  return y.a ^ y.b;
}

// Element i of randint(k, shape, lo, hi) (threefry.py randint).
NGX_HD int tf_randint(TfKey k, uint32_t i, int lo, int hi) {
  const uint32_t higher = tf_bits(tf_child(k, 0), i);
  const uint32_t lower = tf_bits(tf_child(k, 1), i);
  const uint32_t span = hi <= lo ? 1u : (uint32_t)((long long)hi - lo);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = (higher % span) * mult + lower % span;
  return (int)((long long)lo + off % span);
}
