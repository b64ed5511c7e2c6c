// ngx's native reset on jax.random's keys, for sm_90a (H100): one launch
// resets a batch's rows, or writes a step's carried state (the rows its done
// mask names reset, the others copied).
//
// It replaces no TPU kernel: ngx draws this reset in XLA (ngx/core/reset.py
// make_reset under jax.vmap), which fuses it.  The plain twin,
// native_reset_plain in ngx_torch/core/reset.py, is some 3,000 small torch
// launches a call whatever the row count, which kept keyed evaluation's card
// idle (PERF.md).  The device code and what bounds it are in
// native_reset.cuh; the wrapper, ngx_torch/ops/native_reset.py, allocates
// the outputs, checks every tensor and launches ngx_native_reset on the
// current stream.

#include "native_reset.cuh"

#if defined(__CUDACC__)

// Warps a block by default: 4 (128 threads), fewer where a row's shared
// memory is large.
enum { NATIVE_RESET_WARPS = 4 };

__global__ void __launch_bounds__(128)
    native_reset_kernel(const __grid_constant__ NativeResetArgs p, int warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wid = threadIdx.x / 32;
  const long long row = (long long)blockIdx.x * warps + wid;
  if (row >= p.n) return;   // the whole warp: row is the warp's
  unsigned char* mine = smem + wid * native_reset_row_bytes(p.hw);
  const DevWarp w;
  native_reset_row(w, p, row, reinterpret_cast<int*>(mine + (size_t)p.hw * sizeof(Key)),
                   reinterpret_cast<Key*>(mine));
}

// Reset n rows (see NativeResetArgs): `in` and `out` are the ten EnvState
// leaves' device pointers in field order (`in` read only with `done`).
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for
// arguments it refuses.
extern "C" int ngx_native_reset(const int* tab, int n, int hw, int n_items,
                                const long long* keys, const long long* parent,
                                long long offset, const unsigned char* done,
                                void* const* in, void* const* out, void* stream) {
  if (!tab || n < 1 || hw < 1 || n_items < 0 || !out || (!keys && !parent) ||
      (done && !in))
    return (int)cudaErrorInvalidValue;
  NativeResetArgs p = {tab,  n,      hw, n_items, keys, parent, offset, done,
                       done ? state_rows(in) : StateRows{}, state_rows(out)};
  const size_t row_bytes = native_reset_row_bytes(hw);
  int warps = NATIVE_RESET_WARPS;
  while (warps > 1 && warps * row_bytes > 48 * 1024) warps /= 2;
  const size_t bytes = warps * row_bytes;
  if (bytes > 48 * 1024) {
    size_t optin = 0;
    cudaError_t e = smem_budget(optin);
    if (e != cudaSuccess) return (int)e;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(native_reset_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (int)((n + (long long)warps - 1) / warps);
  native_reset_kernel<<<grid, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      p, warps);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
