// gather_wgrad: weight gradient of the gather-matmul sparse convolution.
//
// Has no Pallas counterpart: it replaces the XLA product of `_gm_bwd_core`
// (link_tpu/sparse/conv.py:608-622, `jnp.dot(feats.T, gk)` per tap), which
// first materialises the gathered (N, Co) copy gk = g[bwd_idx[k]] of the
// output gradient for every tap. Contract:
//
//     dW[k] = sum_i feats[i]^T (x) g[bwd_idx[k, i]]   over bwd_idx[k, i] >= 0
//
// feats (N, Ci) and g (M, Co) in one dtype (float32 or bfloat16, widened to
// float32 so the products are exact), bwd_idx (K, N) int32 (the inverse
// kernel map: the output row that input row i feeds through tap k, or -1),
// dW (K, Ci, Co) float32.
//
// What bounds it on the H100: at the training path's level-0 shape (N = M =
// 169,984, K = 27, Ci = Co = 64, float32) feats, g and the index are 105 MB,
// 0.031 ms at 3.35 TB/s, while the products of the ~10% of (tap, row) slots
// that hit are ~4 GFLOP, ~0.06 ms at the 67 TFLOP/s of the CUDA cores: bound
// by arithmetic. This first version runs float32 FMAs (no tensor cores).
//
// Design: the reduction runs over rows, and blocks run in no order, so the
// rows are cut into chunks of ROWS; block (chunk, tap, channel tile) sums
// its chunk's outer products into a 64 x 64 register tile (4 x 4 per
// thread) and writes it to its own slice of a scratch buffer; a second
// small kernel adds the chunks in index order. No atomics: the result is
// the same from run to run. Within a chunk the block reads 256 indices at
// a time, compacts the hits in row order (warp ballot + prefix over the 8
// warps) before it touches g, and stages 32 hit rows of feats and g in
// shared memory per step. Ragged Ci / Co (the stem's Ci = 4) are masked,
// not padded.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 64;     // channel tile (rows of dW[k]: Ci, columns: Co)
constexpr int TR = 32;     // hit rows staged per step
constexpr int NT = 256;    // threads per block (16 x 16, 4 x 4 outputs each)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// partial[(chunk * k + tap)][ci][co] = sum over the chunk's rows.
template <typename T>
__global__ void __launch_bounds__(NT)
gather_wgrad_kernel(const T* __restrict__ feats, int n, int ci,
                    const T* __restrict__ g, int m, int co,
                    const int* __restrict__ bwd_idx, int k, int rows,
                    int co_tiles, float* __restrict__ partial) {
  __shared__ float As[TR][TC];     // feats rows of the staged hits
  __shared__ float Gs[TR][TC];     // g rows of the staged hits
  __shared__ int hit_i[NT];
  __shared__ int hit_j[NT];
  __shared__ int warp_hits[NT / 32];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int chunk = blockIdx.x;
  const int tap = blockIdx.y;
  const int c0 = (blockIdx.z / co_tiles) * TC;   // first Ci of the tile
  const int n0 = (blockIdx.z % co_tiles) * TC;   // first Co of the tile
  const int row0 = chunk * rows;
  const int row1 = min(n, row0 + rows);
  const int* idx = bwd_idx + (long long)tap * n;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int base = row0; base < row1; base += NT) {
    // 256 indices, hits compacted in row order
    const int i = base + tid;
    int j = -1;
    if (i < row1) {
      j = idx[i];
      if (j >= m) j = -1;
    }
    const unsigned vote = __ballot_sync(0xffffffffu, j >= 0);
    if (lane == 0) warp_hits[warp] = __popc(vote);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const int c = warp_hits[w];
      if (w < warp) before += c;
      total += c;
    }
    if (j >= 0) {
      const int pos = before + __popc(vote & ((1u << lane) - 1u));
      hit_i[pos] = i;
      hit_j[pos] = j;
    }
    __syncthreads();

    for (int h0 = 0; h0 < total; h0 += TR) {
      const int nh = min(TR, total - h0);
      for (int e = tid; e < TR * TC; e += NT) {
        const int r = e / TC;
        const int c = e % TC;
        float a = 0.f, b = 0.f;
        if (r < nh) {
          if (c0 + c < ci) a = to_f32(feats[(long long)hit_i[h0 + r] * ci + c0 + c]);
          if (n0 + c < co) b = to_f32(g[(long long)hit_j[h0 + r] * co + n0 + c]);
        }
        As[r][c] = a;
        Gs[r][c] = b;
      }
      __syncthreads();
      for (int r = 0; r < nh; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = As[r][ty + 16 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = Gs[r][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
      __syncthreads();
    }
  }

  float* out = partial + ((long long)chunk * k + tap) * ci * co;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = c0 + ty + 16 * p;
    if (r >= ci) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = n0 + tx + 16 * q;
      if (c < co) out[(long long)r * co + c] = acc[p][q];
    }
  }
}

// dw[e] = sum over chunks of partial[chunk][e], chunks in index order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    int chunks, long long elems,
                                    float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * elems + e];
  dw[e] = s;
}

template <typename T>
int launch(const void* feats, int n, int ci, const void* g, int m, int co,
           const void* bwd_idx, int k, int rows, int chunks, void* partial,
           void* dw, cudaStream_t stream) {
  const int ci_tiles = (ci + TC - 1) / TC;
  const int co_tiles = (co + TC - 1) / TC;
  const dim3 grid(chunks, k, ci_tiles * co_tiles);
  gather_wgrad_kernel<T><<<grid, NT, 0, stream>>>(
      (const T*)feats, n, ci, (const T*)g, m, co, (const int*)bwd_idx, k,
      rows, co_tiles, (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)k * ci * co;
  wgrad_reduce_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, chunks, elems, (float*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feats and g). `partial` is scratch of
// chunks * k * ci * co floats with chunks = ceil(n / rows); `dw` receives
// (k, ci, co) floats. All pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launches.
extern "C" int gather_wgrad(const void* feats, int n, int ci, const void* g,
                            int m, int co, const void* bwd_idx, int k,
                            int rows, int chunks, void* partial, void* dw,
                            int dtype, void* stream) {
  if (n <= 0 || k <= 0 || ci <= 0 || co <= 0 || rows <= 0 ||
      (long long)chunks * rows < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, n, ci, g, m, co, bwd_idx, k, rows, chunks,
                         partial, dw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, n, ci, g, m, co, bwd_idx, k, rows,
                                 chunks, partial, dw, s);
  return (int)cudaErrorInvalidValue;
}
