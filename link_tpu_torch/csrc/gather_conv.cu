// gather_conv: gather-matmul sparse convolution over a kernel map.
//
// Replaces the Pallas kernel `pallas_sparse_conv` (link_tpu/ops/
// pallas_kernels.py:111-144, body `_conv_kernel` :92-108). Same contract:
//
//     out[m] = sum_k feats[idx[k, m]] @ W[k]      (idx < 0 reads a zero row)
//
// feats (N, Ci), idx (K, M) int32, W (K, Ci, Co), out (M, Co), all in one
// dtype (float32 or bfloat16); the sum accumulates in float32 registers and
// is rounded to the feature dtype once, at the single write of each output.
//
// What bounds it on the H100: at the main path's shapes (K = 27, Ci = Co =
// 64, M = 84,992) the products are ~19 GFLOP per call against ~50 MB of
// input and output, so it is bound by arithmetic; this first version runs
// the products as float32 FMAs on the CUDA cores (no tensor cores yet).
//
// Design: one block owns a 64-row by 64-column output tile and walks the K
// taps. For each tap it loads the tile's 64 indices, skips the tap when all
// 64 miss (a block-wide vote; at seg density most taps of many tiles are
// empty), gathers the hit rows into shared memory 32 channels at a time (a
// warp reads one 128-byte row segment), stages the matching 32 x 64 slice of
// W[k], and accumulates a 4 x 4 micro-tile per thread. Each output element
// is written once, with no atomics and no scatter, so the result does not
// depend on scheduling. Tensor-core MMA, cp.async/TMA pipelining and reuse
// of W across tiles are left for later changes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int CK = 32;   // input channels staged per step
constexpr int NT = 256;  // threads per block (16 x 16, 4 x 4 outputs each)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gather_conv_kernel(const T* __restrict__ feats, int n, int ci,
                   const int* __restrict__ idx, int k, int m,
                   const T* __restrict__ w, int co, T* __restrict__ out) {
  __shared__ float As[CK][TM + 1];  // gathered rows, channel-major; +1 pad
  __shared__ float Ws[CK][TN];
  __shared__ int rows[TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kk = 0; kk < k; ++kk) {
    int hit = 0;
    if (tid < TM) {
      int r = -1;
      if (m0 + tid < m) {
        r = idx[(long long)kk * m + m0 + tid];
        if (r >= n) r = -1;
      }
      rows[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;

    const T* wk = w + (long long)kk * ci * co;
    for (int c0 = 0; c0 < ci; c0 += CK) {
      for (int e = tid; e < TM * CK; e += NT) {
        const int r = e / CK;
        const int c = e % CK;
        const int row = rows[r];
        float v = 0.f;
        if (row >= 0 && c0 + c < ci) v = to_f32(feats[(long long)row * ci + c0 + c]);
        As[c][r] = v;
      }
      for (int e = tid; e < CK * TN; e += NT) {
        const int c = e / TN;
        const int j = e % TN;
        float v = 0.f;
        if (c0 + c < ci && n0 + j < co) v = to_f32(wk[(long long)(c0 + c) * co + n0 + j]);
        Ws[c][j] = v;
      }
      __syncthreads();
      const int kc = min(CK, ci - c0);
      for (int c = 0; c < kc; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < co) store(out + (long long)r * co + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* feats, int n, int ci, const void* idx, int k, int m,
           const void* w, int co, void* out, void* stream) {
  if (m > 0 && co > 0) {
    const dim3 grid((m + TM - 1) / TM, (co + TN - 1) / TN);
    gather_conv_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)feats, n, ci, (const int*)idx, k, m, (const T*)w, co, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers;
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_conv(const void* feats, int n, int ci, const void* idx,
                           int k, int m, const void* w, int co, void* out,
                           int dtype, void* stream) {
  if (dtype == 0) return launch<float>(feats, n, ci, idx, k, m, w, co, out, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(feats, n, ci, idx, k, m, w, co, out, stream);
  return (int)cudaErrorInvalidValue;
}
