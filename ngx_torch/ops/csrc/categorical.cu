// ngx's jax.random.categorical(key, logits) over a [B, A] float32 batch of
// logits from one key, for sm_90a (H100): one launch draws every row's
// action.
//
// It replaces no TPU kernel: ngx draws the categorical in XLA, which fuses
// it.  The plain twin, categorical in ngx_torch/ops/threefry.py, is some 200
// small torch launches a call (threefry on int64-masked words over the B x A
// counters, the uniform, two logs, an add and an argmax), which kept keyed
// evaluation's card idle (PERF.md).  The wrapper, ngx_torch/ops/
// categorical.py, checks the tensors, allocates the output and launches
// ngx_categorical on the current stream.
//
// The arithmetic is the twin's, element for element: element (b, a) hashes
// counter i = b * A + a (partitionable bits, the two words xored); its
// uniform on [tiny, 1) is float32(double(f) * double(1 - tiny) +
// double(tiny)), clamped below at tiny, with f the float in [0, 1) of the
// top 23 bits (the twin's one float64 product and sum, rounded once); its
// score is -logf(-logf(u)) + logit, with the IEEE logf (no
// -use_fast_math), the function torch's log calls on the card; the action
// is the first index of the largest score, torch.argmax's rule (a NaN above
// every number).  So on the card the actions equal the twin's bit for bit.
//
// The device functions are __host__ __device__: g++ builds this file for
// the host (tests/test_torch_categorical_kernel.py), where the lanes of a
// row run in turn.  Launch code stays behind __CUDACC__.
//
// What bounds it: nothing of the card.  At B 1,024 and A 17 a launch is
// 17,408 threefry blocks (about 1.7 M integer operations, 0.1 us at 16.7
// TOP/s) over 78 KB (0.02 us at 3.35 TB/s); its latency and the wrapper's
// host work are what cost.  The design: a warp a row, lanes striding the
// actions, each lane keeping its best (score, index), then a shuffle
// reduction in which a tie goes to the lower index; 8 warps a block.

#include "threefry.cuh"

// float32 tiny (np.finfo(np.float32).tiny), the uniform's lower bound
#define CAT_TINY 1.17549435082228750797e-38f

NGX_HD float cat_float_of_bits(uint32_t w) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(w);
#else
  float f;
  memcpy(&f, &w, sizeof f);
  return f;
#endif
}

// uniform(key, shape, tiny, 1) of the bits b (threefry.py uniform): the
// float64 product and sum rounded separately, no contraction
NGX_HD float cat_uniform(uint32_t b) {
  const float f = cat_float_of_bits((b >> 9) | 0x3F800000u) - 1.0f;
  const double scale = (double)(1.0f - CAT_TINY), lo = (double)CAT_TINY;
#if defined(__CUDA_ARCH__)
  const float u = (float)__dadd_rn(__dmul_rn((double)f, scale), lo);
#else
  const double prod = (double)f * scale;
  const float u = (float)(prod + lo);
#endif
  return u > CAT_TINY ? u : CAT_TINY;
}

// gumbel's -log(-log(u)) in float32
NGX_HD float cat_gumbel(float u) { return -logf(-logf(u)); }

// torch.argmax's order on (score, index) pairs of distinct indices: a NaN
// above every number (the lower index first among NaNs), else the larger
// score, else the lower index.  A strict total order, so any order of
// reduction finds the same first maximum.
NGX_HD bool cat_better(float s, int i, float t, int j) {
  const bool ns = s != s, nt = t != t;
  if (ns || nt) return ns && (!nt || i < j);
  return s > t || (s == t && i < j);
}

// Lane `lane`'s best (score, index) of one row over the actions lane, lane
// + 32, ...; `ctr` is the counter of the row's action 0.  A lane with no
// action keeps (-inf, A), which every action of the row beats.
NGX_HD void cat_lane(TfKey k, const float* row, int n_actions,
                     unsigned long long ctr, int lane, float& best, int& idx) {
  best = -INFINITY;
  idx = n_actions;
  for (int a = lane; a < n_actions; a += 32) {
    const float s =
        cat_gumbel(cat_uniform(tf_bits(k, (uint32_t)(ctr + (unsigned)a)))) + row[a];
    if (cat_better(s, a, best, idx)) {
      best = s;
      idx = a;
    }
  }
}

#if defined(__CUDACC__)

enum { CATEGORICAL_WARPS = 8 };

__global__ void __launch_bounds__(CATEGORICAL_WARPS * 32)
    categorical_kernel(const long long* __restrict__ key,
                       const float* __restrict__ logits, long long* __restrict__ out,
                       int n, int n_actions) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * CATEGORICAL_WARPS + threadIdx.x / 32;
  if (row >= n) return;   // the whole warp: row is the warp's
  const TfKey k{(uint32_t)key[0], (uint32_t)key[1]};
  float s;
  int i;
  cat_lane(k, logits + row * n_actions, n_actions,
           (unsigned long long)row * (unsigned long long)n_actions, lane, s, i);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float s2 = __shfl_xor_sync(0xFFFFFFFFu, s, o);
    const int i2 = __shfl_xor_sync(0xFFFFFFFFu, i, o);
    if (cat_better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
  if (lane == 0) out[row] = i;
}

// The actions of n rows of n_actions logits (row-major float32 [n,
// n_actions]) on key ([2] int64, the words of jax.random.key_data) into
// out ([n] int64).  Every counter must fit 32 bits.  Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int ngx_categorical(const long long* key, const float* logits, int n,
                               int n_actions, long long* out, void* stream) {
  if (!key || !logits || !out || n < 1 || n_actions < 1 ||
      (unsigned long long)n * (unsigned long long)n_actions > 0xFFFFFFFFull)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((n + (long long)CATEGORICAL_WARPS - 1) / CATEGORICAL_WARPS);
  categorical_kernel<<<grid, CATEGORICAL_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(key, logits, out, n,
                                                            n_actions);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
