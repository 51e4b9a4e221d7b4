// mma_sm90.cuh: tensor-core and async-copy helpers shared by the sparse
// conv kernels (gather_conv.cu, gather_wgrad.cu, window_conv.cu); the NMS
// walk (rotated_nms.cu) takes its cp.async helpers.
//
// Products run as warp-level `mma.sync`:
//   * bfloat16 inputs: m16n8k16 bf16 x bf16 -> f32. The products of two
//     bf16 values are exact in f32, as in the plain twins.
//   * float32 inputs: m16n8k8 tf32 x tf32 -> f32, THREE times per product
//     ("3xTF32"): with hi = tf32(x) and lo = tf32(x - hi) (`split_tf32`),
//         a * b ~= hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b)
//     (the lo * lo term, < 2^-20 relative, is dropped). One TF32 pass keeps
//     a 10-bit mantissa: emulated on a real seg plan (K = 27, 64 channels)
//     it misses the 1e-5 bound that holds every float32 kernel to its twin,
//     while the three passes stay more than ten times under it, next to
//     plain float32 FMAs (tests/test_torch_tf32_split.py). So float32 never
//     reaches the tensor cores as a single TF32 pass. The small terms are
//     added first.
//   * The tensor core's float32 accumulation does not round to nearest: a
//     chain of thousands of MMAs into one accumulator drifts by a good part
//     of that bound. The kernels start each short chain from zero and add
//     it into their sum with a float32 add.
//
// Why `mma.sync` and not Hopper's `wgmma`: `wgmma` works on 64-row A tiles
// per warpgroup. The sparse conv multiplies the hit rows of one (tile, tap)
// pair after compacting them, ~14 rows on average per 64-row tile (~24 per
// 128-row tile) at the seg path's density, so a 64-row operand would be
// mostly padding; `mma.sync`'s 16-row tiles match the data. A later change
// may take `wgmma` where the profile shows the MMA issue rate as the limit.
//
// Copies into shared memory are `cp.async` of 16, 8 or 4 bytes with a
// source size: a source size of 0 writes zeros and reads nothing from global
// memory, so a missed or padding row costs no read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace mma_sm90 {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------- 3xTF32

// x ~= hi + lo with hi, lo exact TF32 values (10 mantissa bits): hi is x
// truncated to TF32, lo = x - hi (exact in float32) truncated again, so
// |x - hi - lo| < 2^-20 |x|. Three full-rate integer / float operations per
// element (`cvt.rna.tf32.f32` runs at a fraction of that rate, and the split
// runs once per operand element of every product).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col), tf32 inputs, f32 accumulator.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (t + 4, g);
// d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The float32 product as three TF32 passes, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// ---------------------------------------------------------------- bf16

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulator.
// Each register holds two bf16, the lower column (a) or row (b) in the low
// half: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8,
// 2t + 8..); b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8q..8q+7
// give the row addresses of matrix q, and register q receives, in lane
// (g, t), elements [2t][g] and [2t + 1][g] of matrix q.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---------------------------------------------------------------- cp.async

// Copy VEC bytes (16, 8 or 4) from global to shared memory; of them,
// `src_bytes` (VEC or 0) are read and the rest are written as zeros.
template <int VEC>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(VEC), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One `vec`-byte piece of a row from gmem to smem (both aligned to `vec`):
// read when `read`, else written as zeros. vec 16, 8 or 4 goes through
// cp.async; vec 2 (bfloat16 rows of odd width) is a plain copy.
struct RowCopy {
  int vec;
  __device__ __forceinline__ void piece(char* smem, const char* gmem,
                                        bool read) const {
    switch (vec) {
      case 16: cp_async<16>(smem, gmem, read ? 16 : 0); break;
      case 8: cp_async<8>(smem, gmem, read ? 8 : 0); break;
      case 4: cp_async<4>(smem, gmem, read ? 4 : 0); break;
      default:
        *reinterpret_cast<uint16_t*>(smem) =
            read ? *reinterpret_cast<const uint16_t*>(gmem) : (uint16_t)0;
    }
  }
};

// The widest piece (16, 8, 4 or 2 bytes) that divides every row's byte
// offset and length, given the base pointer and the row pitch in bytes.
inline int copy_vec(const void* base, long long pitch_bytes) {
  const unsigned long long a =
      (unsigned long long)base | (unsigned long long)pitch_bytes;
  if (a % 16 == 0) return 16;
  if (a % 8 == 0) return 8;
  if (a % 4 == 0) return 4;
  return 2;
}

// Raise the dynamic shared memory limit of `kernel` to `bytes` (above 48 KB
// a launch needs it), once per kernel and size.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

}  // namespace mma_sm90
