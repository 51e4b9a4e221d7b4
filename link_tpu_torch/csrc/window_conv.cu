// window_conv: window-form sparse convolution over a sorted-row plan.
//
// Replaces the Pallas kernel `onehot_window_conv` (link_tpu/ops/
// pallas_kernels.py:179-276) at the place where link_tpu runs the window
// form in XLA (`_win_apply_impl`, link_tpu/sparse/conv.py:478-485). Same
// output contract:
//
//     out[m] = sum_g sum_{t in groups[g]}
//                  (slot[t, m] >= 0 ? feats[base_pos[g, m] + slot[t, m]] : 0)
//                  @ W[t]
//
// feats (N, Ci), base_pos (Gg, M) int32, slot (K, M) int8 (-1 = miss),
// W (K, Ci, Co), out (M, Co); feats, W and out in one dtype (float32 or
// bfloat16). The groups arrive flat: `taps` lists tap ids group by group and
// `goff[g] .. goff[g+1]` bounds group g's entries. The sum accumulates in
// float32 registers and is rounded to the feature dtype once, at the single
// write of each output. Rows at or past N read zeros.
//
// The Pallas kernel builds a one-hot matmul over two contiguous DMA slabs
// only because Mosaic has no in-VMEM gather; on Hopper a block reads each
// output row's window straight from device memory (L2), so neither the
// one-hot nor the slab-coverage limit (`window_starts` / `window_overflow`)
// carries over.
//
// What bounds it on the H100: at the det backbone's level-0 shapes (M =
// 163,840, G = 3 taps a group, Ci = Co = 16) the function needs ~10 MB of
// input and output and, counting hit taps only, well under a GFLOP, so its
// bound is bytes; this first version multiplies the whole tile for every
// tap with a hit in the tile (dense over misses) on the CUDA cores.
//
// Design: one block owns a 64-row by TN-column output tile (TN = 16 or 32)
// and walks the tap groups. For each group it loads the tile's 64 base rows
// and the group's slots, skips the group when no tap of it hits in the tile
// (a block-wide vote), then reads each output row's window
// feats[base .. base + G - 1] into shared memory in 32-channel chunks --
// consecutive threads read consecutive addresses of one row's window, which
// is one contiguous span of G * Ci elements when Ci <= 32 -- widened to
// float32. It stages the matching slice of W[t] for every tap of the group,
// and each thread routes its rows' slots into the window and accumulates a
// 4 x (TN / 16) micro-tile. Each output element is written once, with no
// atomics, so the result does not depend on scheduling. Tensor cores,
// TMA and pipelining are left for later changes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int CK = 32;        // input channels staged per step
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int MAX_TAPS = 8;   // taps per group and window width the kernel takes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Dynamic shared memory: win[gw][CK][TM + 1] floats, then ws[MAX_TAPS][CK][TN]
// floats (only the group's taps are used).
template <typename T, int TN>
__global__ void __launch_bounds__(NT)
window_conv_kernel(const T* __restrict__ feats, int n, int ci,
                   const int* __restrict__ base_pos,
                   const int8_t* __restrict__ slot, int m,
                   const int* __restrict__ taps, const int* __restrict__ goff,
                   int n_groups, int gw, const T* __restrict__ w, int co,
                   T* __restrict__ out) {
  extern __shared__ float smem[];
  float* win = smem;                                   // [gw][CK][TM + 1]
  float* ws = smem + gw * CK * (TM + 1);               // [MAX_TAPS][CK][TN]
  __shared__ int base_s[TM];
  __shared__ int slot_s[MAX_TAPS][TM];
  __shared__ int hit_s[MAX_TAPS];

  constexpr int JN = TN / 16;                          // columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;

  float acc[4][JN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    const int t_begin = __ldg(goff + g);
    const int nt = __ldg(goff + g + 1) - t_begin;

    // base rows and slots of the tile; which taps hit anywhere in it
    if (tid < TM) {
      base_s[tid] = (m0 + tid < m) ? base_pos[(long long)g * m + m0 + tid] : 0;
    }
    if (tid < MAX_TAPS) hit_s[tid] = 0;
    __syncthreads();
    int any = 0;
    for (int e = tid; e < nt * TM; e += NT) {
      const int ti = e / TM;
      const int r = e % TM;
      int s = -1;
      if (m0 + r < m) {
        const int t = __ldg(taps + t_begin + ti);
        s = (int)slot[(long long)t * m + m0 + r];   // int8 sign-extends: -1 stays -1
        if (s >= gw) s = -1;
      }
      slot_s[ti][r] = s;
      if (s >= 0) {
        any = 1;
        hit_s[ti] = 1;                               // benign race: all write 1
      }
    }
    if (!__syncthreads_or(any)) continue;

    for (int c0 = 0; c0 < ci; c0 += CK) {
      const int kc = min(CK, ci - c0);
      // window rows base .. base + gw - 1 of each output row: for one row,
      // consecutive e read consecutive addresses (one span when kc == ci)
      for (int e = tid; e < TM * gw * kc; e += NT) {
        const int r = e / (gw * kc);
        const int rem = e % (gw * kc);
        const int j = rem / kc;
        const int c = rem % kc;
        const long long row = (long long)base_s[r] + j;
        float v = 0.f;
        if (m0 + r < m && row >= 0 && row < n) {
          v = to_f32(feats[row * ci + c0 + c]);
        }
        win[(j * CK + c) * (TM + 1) + r] = v;
      }
      // W[t][c0 .. c0 + kc)[n0 .. n0 + TN) for each tap of the group
      for (int e = tid; e < nt * kc * TN; e += NT) {
        const int ti = e / (kc * TN);
        const int rem = e % (kc * TN);
        const int c = rem / TN;
        const int j = rem % TN;
        float v = 0.f;
        if (hit_s[ti] && n0 + j < co) {
          const int t = __ldg(taps + t_begin + ti);
          v = to_f32(w[((long long)t * ci + c0 + c) * co + n0 + j]);
        }
        ws[(ti * CK + c) * TN + j] = v;
      }
      __syncthreads();
      for (int ti = 0; ti < nt; ++ti) {
        if (!hit_s[ti]) continue;                    // uniform across the block
        int sl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sl[i] = slot_s[ti][ty + 16 * i];
        const float* wt = ws + ti * CK * TN;
        for (int c = 0; c < kc; ++c) {
          float a[4], b[JN];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = sl[i] >= 0 ? win[(sl[i] * CK + c) * (TM + 1) + ty + 16 * i]
                              : 0.f;
          }
#pragma unroll
          for (int j = 0; j < JN; ++j) b[j] = wt[c * TN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < co) store(out + (long long)r * co + col, acc[i][j]);
    }
  }
}

template <typename T, int TN>
int launch(const void* feats, int n, int ci, const void* base_pos,
           const void* slot, int m, const void* taps, const void* goff,
           int n_groups, int gw, const void* w, int co, void* out,
           void* stream) {
  const size_t smem = sizeof(float) * ((size_t)gw * CK * (TM + 1)
                                       + (size_t)MAX_TAPS * CK * TN);
  cudaError_t err = cudaFuncSetAttribute(
      window_conv_kernel<T, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + TM - 1) / TM, (co + TN - 1) / TN);
  window_conv_kernel<T, TN><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)feats, n, ci, (const int*)base_pos, (const int8_t*)slot, m,
      (const int*)taps, (const int*)goff, n_groups, gw, (const T*)w, co,
      (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* feats, int n, int ci, const void* base_pos,
             const void* slot, int m, const void* taps, const void* goff,
             int n_groups, int gw, const void* w, int co, void* out,
             void* stream) {
  if (co <= 16) {
    return launch<T, 16>(feats, n, ci, base_pos, slot, m, taps, goff,
                         n_groups, gw, w, co, out, stream);
  }
  return launch<T, 32>(feats, n, ci, base_pos, slot, m, taps, goff, n_groups,
                       gw, w, co, out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `gw` is the window width (the largest
// group); every group holds at most MAX_TAPS taps and gw <= MAX_TAPS. All
// pointers are device pointers; `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int window_conv(const void* feats, int n, int ci,
                           const void* base_pos, const void* slot, int m,
                           const void* taps, const void* goff, int n_groups,
                           int gw, const void* w, int co, void* out, int dtype,
                           void* stream) {
  if (gw < 1 || gw > MAX_TAPS || n < 1) return (int)cudaErrorInvalidValue;
  if (m <= 0 || co <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    return dispatch<float>(feats, n, ci, base_pos, slot, m, taps, goff,
                           n_groups, gw, w, co, out, stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(feats, n, ci, base_pos, slot, m, taps,
                                   goff, n_groups, gw, w, co, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
