// elk_aggregate: the ELK block's aux aggregation and its feature gradient,
// both in gather form.
//
// Has no Pallas counterpart: it replaces the XLA segment-sum and gather
// chain of link_tpu/ops/elk.py (voxel_to_aux :100-121, the mean pool of
// spvoxelize; aux_to_voxel :124-186, the count-weighted r^3 window sum of
// spdevoxelize and the broadcast back to the voxels), which the port ran
// as PyTorch index_select / index_add_ chains. Their backward scattered
// every aux row, padding included, with float atomics; a window of
// capacity-sized aux tables sent all padding rows and misses to one dump
// row, so millions of atomics met on the same 193 addresses. Contract,
// over one plan (link_tpu_torch/ops/elk.py, `elk_aux_plan`):
//
//     S[j]     = sum_{p in [start[j], start[j+1])} x[order[p]],  c[j] its count
//     pool[j]  = (S[j] / c[j]) * c[j]     forward: the mean, count-weighted
//              = S[j] / denom[j]          backward
//     out[v]   = sum_k pool[taps[k, j]] (/ denom[j] forward) for every voxel
//                v of aux cell j (v = order[p], p in cell j's range); 0 for
//                the rows past start[m] (no aux cell)
//
// order (N,) the voxel rows sorted by aux cell (in row order within a cell),
// start (M + 1,) each cell's first position, so c[j] = start[j + 1] -
// start[j]; taps (K, M) the window's self-join (aux row of tap k of row j,
// or -1). Forward (grad = 0): x the modulated features; the window kernel
// also computes the window count denom[j] = sum_k c[taps[k, j]] (1 where
// that is 0), the reference's count channel, and writes it for the
// backward. Backward (grad = 1): x the output gradient, taps the plan's
// inverse (inv[k, j] = i with taps[k, i] == j): d x[u] = sum_k (S_g / denom)
// [inv[k, cell(u)]], the forward's derivative with the counts constant.
//
// Every sum is a float32 sum in a fixed order (a cell's voxels by p, the
// taps by k). Rows arrive and leave in the model's dtype (float32 or
// bfloat16); in the forward, a value is rounded to that dtype where the
// reference composition (spvoxelize / spdevoxelize) rounds it: the aux
// mean, its count product, the window sum, the window count and the
// quotient, so that a bfloat16 model gives the JAX package's values; the
// backward rounds once, at the end. No atomics: two runs are bit-equal, and
// so is a rematerialized block's replay. Rows at or past the device-side
// nnz, and -1 taps, do no work; nothing is written to a dump row.
//
// What bounds it on the H100: bytes. At the seg cell's finest ELK level
// (124,928 voxel rows of 192 float32 channels, about half the 124,928 aux
// rows live, ~2 voxels each) one direction reads the cells' voxel rows
// once, writes and gathers the live pool rows, and writes every voxel row
// once: ~0.28 GB, ~0.085 ms at 3.35 TB/s. Design: one warp per aux row, both kernels walking the rows < nnz
// (read on the device, so the grid is sized from the capacity and no host
// synchronisation is needed); each lane holds 16-byte vectors of up to 2 x
// 32 x 4 channels in registers; the warp's 32 lanes load 32 voxel ids (or
// taps) at once and pass them round by shuffles. The window kernel also
// writes the result to the cell's voxel rows (the broadcast), so the
// per-cell result never reaches memory, and zeroes the rows of no cell.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;  // one resident wave of 2,048 threads/SM
constexpr int kChunks = 2;           // vectors a lane holds per pass
constexpr unsigned kFull = 0xffffffffu;

// V consecutive elements of T <-> V floats.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 a;
    a.x = *reinterpret_cast<const unsigned*>(&lo);
    a.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = a;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

// A float32 value rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// pool[j] from the sum of cell j's rows of x: the count-weighted mean, or
// (with denom) the sum divided by denom[j], for j < nnz; one warp a cell,
// lanes over the channels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    elk_pool_kernel(const T* __restrict__ x, int c,
                    const int* __restrict__ order,
                    const int* __restrict__ start,
                    const int* __restrict__ nnz_p,
                    const float* __restrict__ denom,
                    float* __restrict__ pool) {
  const int lane = threadIdx.x & 31;
  const int nnz = __ldg(nnz_p);
  const int cv = c / V;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < nnz;
       j += gridDim.x * kWarps) {
    const int p0 = __ldg(start + j);
    const int p1 = __ldg(start + j + 1);
    const float count = (float)(p1 - p0);
    const float d = denom != nullptr ? __ldg(denom + j) : 1.f;
    for (int c0 = 0; c0 < cv; c0 += 32 * kChunks) {
      float acc[kChunks][V];
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.f;
      for (int b = p0; b < p1; b += 32) {
        const int mine = b + lane < p1 ? __ldg(order + b + lane) : 0;
        const int width = min(32, p1 - b);
#pragma unroll 4
        for (int t = 0; t < width; ++t) {
          const int row = __shfl_sync(kFull, mine, t);
          const T* src = x + (long long)row * c;
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            const int vi = c0 + q * 32 + lane;
            if (vi < cv) {
              float v[V];
              Vec<T, V>::load(src + vi * V, v);
#pragma unroll
              for (int e = 0; e < V; ++e) acc[q][e] += v[e];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int vi = c0 + q * 32 + lane;
        if (vi < cv) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[q][e] = denom != nullptr
                            ? acc[q][e] / d
                            : round_to<T>(round_to<T>(acc[q][e] / count) * count);
          Vec<float, V>::store(pool + (long long)j * c + vi * V, acc[q]);
        }
      }
    }
  }
}

// For each cell j < nnz: the sum of the pool rows of its K taps (-1 taps
// skipped), in the forward divided by the window count (written to denom),
// stored to every voxel row of the cell; then zeros to the rows past
// start[m]. One warp a cell, lanes over the channels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    elk_window_kernel(const float* __restrict__ pool, int c,
                      const int* __restrict__ taps, int k, int m,
                      const int* __restrict__ order,
                      const int* __restrict__ start,
                      const int* __restrict__ nnz_p, int n, int forward,
                      float* __restrict__ denom, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int warps = gridDim.x * kWarps;
  const int nnz = __ldg(nnz_p);
  const int cv = c / V;
  for (int j = warp; j < nnz; j += warps) {
    const int p0 = __ldg(start + j);
    const int p1 = __ldg(start + j + 1);
    float d = 1.f;
    if (forward) {
      int count = 0;
      for (int t = lane; t < k; t += 32) {
        const int i = __ldg(taps + (long long)t * m + j);
        if (i >= 0) count += __ldg(start + i + 1) - __ldg(start + i);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        count += __shfl_xor_sync(kFull, count, off);
      d = round_to<T>((float)count);
      if (d == 0.f) d = 1.f;
      if (lane == 0) denom[j] = d;
    }
    for (int c0 = 0; c0 < cv; c0 += 32 * kChunks) {
      float acc[kChunks][V];
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.f;
      for (int t0 = 0; t0 < k; t0 += 32) {
        const int mine =
            t0 + lane < k ? __ldg(taps + (long long)(t0 + lane) * m + j) : -1;
        const int width = min(32, k - t0);
#pragma unroll 4
        for (int t = 0; t < width; ++t) {
          const int i = __shfl_sync(kFull, mine, t);
          if (i < 0) continue;
          const float* src = pool + (long long)i * c;
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            const int vi = c0 + q * 32 + lane;
            if (vi < cv) {
              float v[V];
              Vec<float, V>::load(src + vi * V, v);
#pragma unroll
              for (int e = 0; e < V; ++e) acc[q][e] += v[e];
            }
          }
        }
      }
      if (forward) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[q][e] = round_to<T>(acc[q][e]) / d;
      }
      for (int b = p0; b < p1; b += 32) {
        const int mine = b + lane < p1 ? __ldg(order + b + lane) : 0;
        const int width = min(32, p1 - b);
        for (int t = 0; t < width; ++t) {
          T* dst = out + (long long)__shfl_sync(kFull, mine, t) * c;
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            const int vi = c0 + q * 32 + lane;
            if (vi < cv) Vec<T, V>::store(dst + vi * V, acc[q]);
          }
        }
      }
    }
  }
  // the rows of no aux cell (padding, overflow) read zero
  float zero[V];
#pragma unroll
  for (int e = 0; e < V; ++e) zero[e] = 0.f;
  for (int p = __ldg(start + m) + warp; p < n; p += warps) {
    T* dst = out + (long long)__ldg(order + p) * c;
    for (int vi = lane; vi < cv; vi += 32) Vec<T, V>::store(dst + vi * V, zero);
  }
}

template <typename T, int V>
int launch(const void* x, int n, int c, const int* order, const int* start,
           int m, const int* nnz, const int* taps, int k, float* denom,
           int grad, float* pool, void* out, cudaStream_t s) {
  const int rows = m > n ? m : n;
  int blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  elk_pool_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      (const T*)x, c, order, start, nnz, grad ? denom : nullptr, pool);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  elk_window_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      pool, c, taps, k, m, order, start, nnz, n, grad ? 0 : 1, denom,
      (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, C) and out (N, C) in dtype (0 = float32, 1 = bfloat16); order (N,),
// start (M + 1,), nnz (1,), taps (K, M) int32; denom (M,) float32, written
// when grad == 0 and read when grad == 1; pool scratch of M * C floats; vec
// 4 (C % 4 == 0, x and out 16-byte aligned for float32, 8 for bfloat16) or
// 1. Two launches. All pointers are device pointers; `stream` is a
// cudaStream_t.
extern "C" int elk_aggregate(const void* x, int dtype, int n, int c,
                             const void* order, const void* start, int m,
                             const void* nnz, const void* taps, int k,
                             void* denom, int grad, void* pool, void* out,
                             int vec, void* stream) {
  if (n < 0 || m < 0 || c <= 0 || k <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* o = (const int*)order;
  const int* st = (const int*)start;
  const int* nz = (const int*)nnz;
  const int* tp = (const int*)taps;
  float* dn = (float*)denom;
  float* pl = (float*)pool;
  if (dtype == 0)
    return vec == 4 ? launch<float, 4>(x, n, c, o, st, m, nz, tp, k, dn, grad,
                                       pl, out, s)
                    : launch<float, 1>(x, n, c, o, st, m, nz, tp, k, dn, grad,
                                       pl, out, s);
  if (dtype == 1)
    return vec == 4 ? launch<__nv_bfloat16, 4>(x, n, c, o, st, m, nz, tp, k,
                                               dn, grad, pl, out, s)
                    : launch<__nv_bfloat16, 1>(x, n, c, o, st, m, nz, tp, k,
                                               dn, grad, pl, out, s);
  return (int)cudaErrorInvalidValue;
}
