// sorted_join: sorted-key join of packed voxel coordinates.
//
// Replaces the Pallas kernel `pallas_join` (link_tpu/ops/pallas_kernels.py:
// 62-89, body `_join_kernel` :48-59, search `_lower_bound_in_vmem` :29-45).
// For each query key pair (q_hi, q_lo) the kernel finds the lower bound in
// the lexicographically sorted table (t_hi, t_lo). Two output modes:
//
//   mode 0 (exact hit): perm[pos] on an exact match, else -1. A query with
//          q_hi == INT32_MAX (padding) always misses. The Pallas contract.
//   mode 1 (lower bound): pos itself, clamped to n - 1, for every query
//          (padding included). The window-form conv plan reads its base
//          rows from it (link_tpu/sparse/coords.py:1088, the grouped query
//          of one lower bound per (dy, dz) tap group).
//
// What bounds it on the H100: each query runs ~log2(N) = 17-18 dependent
// probes at N = 84,992..163,840, so it is bound by the latency of those
// dependent loads, not by bytes or operations (the least bytes are the
// table once plus the queries and the output once). The table is 1-2 MB and
// stays resident in the 50 MB L2, so every probe after the first few is an
// L2 hit; one thread per query and many warps per SM hide the probe
// latency. Caching the top levels of the search in shared memory is left
// for a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

namespace {

constexpr int kInt32Max = 2147483647;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sorted_join_kernel(const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                   const int* __restrict__ perm, int n,
                   const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                   int* __restrict__ out, long long q, int mode) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= q) return;
  const int qh = q_hi[i];
  const int ql = q_lo[i];
  if (mode == 0 && qh == kInt32Max) {
    out[i] = -1;
    return;
  }
  unsigned lo = 0, hi = (unsigned)n;
  while (lo < hi) {
    const unsigned mid = (lo + hi) >> 1;
    const int th = __ldg(t_hi + mid);
    const int tl = __ldg(t_lo + mid);
    if (th < qh || (th == qh && tl < ql)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (mode == 1) {
    out[i] = lo < (unsigned)n ? (int)lo : n - 1;
    return;
  }
  int res = -1;
  if (lo < (unsigned)n && __ldg(t_hi + lo) == qh && __ldg(t_lo + lo) == ql) {
    res = __ldg(perm + lo);
  }
  out[i] = res;
}

}  // namespace

// All pointers are device pointers (perm may be null in mode 1); `stream` is
// a cudaStream_t; n >= 1. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sorted_join(const void* t_hi, const void* t_lo, const void* perm,
                           int n, const void* q_hi, const void* q_lo, void* out,
                           long long q, int mode, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (q > 0) {
    const long long blocks = (q + kThreads - 1) / kThreads;
    sorted_join_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)t_hi, (const int*)t_lo, (const int*)perm, n,
        (const int*)q_hi, (const int*)q_lo, (int*)out, q, mode);
  }
  return (int)cudaGetLastError();
}
