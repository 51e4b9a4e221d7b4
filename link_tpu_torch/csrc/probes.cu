// probes: row-gather, slab-copy and empty-launch probe kernels.
//
// They replace the Mosaic probes of tools/probe_mosaic.py and
// tools/probe_mosaic2.py, which time what a Pallas kernel can do on the TPU
// (an in-VMEM row gather written as jnp.take, take_along_axis, a one-hot
// matmul or a 1-D / lane gather; DMA slab copies at dynamic offsets; a
// scalar-prefetched block fetch; an empty pallas_call). Here the same
// output contracts measure what a hand-written block can do on the H100:
//
//   probe_row_gather  out[q, :] = x[idx[q], :]  (idx < 0 or >= N: zero row),
//                     rows of 2 B to any width, moved 16 bytes a thread
//                     where the row width and the pointers allow (else 8,
//                     4 or 2). Bound by bytes: Q rows read and written plus
//                     4 Q of index at 3.35 TB/s; a table under the 50 MB L2
//                     is served from L2, so a reading above the HBM rate is
//                     expected there.
//   probe_slab_copy   one block per offset copies rows [off, off + G) of x
//                     into shared memory with cp.async (16 B per thread per
//                     copy), waits, and writes either the slab's
//                     first 4 bytes (slab mode) or its first BQ rows (window
//                     mode) to the output. An offset outside [0, N - G]
//                     reads as an all-zero slab. Bound by the bytes copied.
//                     A slab above 48 KB needs the dynamic shared memory
//                     attribute; a slab the card cannot hold is refused by
//                     the launch and comes back as the return code.
//   probe_empty       copies one (8, 128) float32 tile: the cost of one
//                     launch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry points, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;

template <typename V>
__global__ void __launch_bounds__(NT)
row_gather_kernel(const V* __restrict__ x, int n, int vpr,
                  const int* __restrict__ idx, long long q,
                  V* __restrict__ out) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= q * vpr) return;
  const long long row = t / vpr;
  const int v = (int)(t % vpr);
  const int src = idx[row];
  V val{};
  if (src >= 0 && src < n) val = x[(long long)src * vpr + v];
  out[t] = val;
}

template <typename V>
int launch_gather(const void* x, int n, int row_bytes, const void* idx,
                  long long q, void* out, cudaStream_t stream) {
  const int vpr = row_bytes / (int)sizeof(V);
  const long long blocks = (q * vpr + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    row_gather_kernel<V><<<(unsigned)blocks, NT, 0, stream>>>(
        (const V*)x, n, vpr, (const int*)idx, q, (V*)out);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(NT)
slab_copy_kernel(const char* __restrict__ x, int n, int row_bytes,
                 const int* __restrict__ offs, int g, int out_rows,
                 char* __restrict__ out) {
  extern __shared__ __align__(16) char slab[];
  const int s = blockIdx.x;
  const int off = offs[s];
  const long long bytes = (long long)g * row_bytes;
  const bool inside = off >= 0 && (long long)off + g <= n;
  if (inside) {
    const char* src = x + (long long)off * row_bytes;
    for (long long b = (long long)threadIdx.x * 16; b < bytes; b += NT * 16)
      cp_async16(slab + b, src + b);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (long long b = (long long)threadIdx.x * 16; b < bytes; b += NT * 16)
      *reinterpret_cast<uint4*>(slab + b) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (out_rows == 0) {           // slab mode: one 4-byte element per slab
    if (threadIdx.x == 0)
      reinterpret_cast<uint32_t*>(out)[s] =
          *reinterpret_cast<const uint32_t*>(slab);
    return;
  }
  const long long ob = (long long)out_rows * row_bytes;
  char* dst = out + (long long)s * ob;
  for (long long b = (long long)threadIdx.x * 16; b < ob; b += NT * 16)
    *reinterpret_cast<uint4*>(dst + b) =
        *reinterpret_cast<const uint4*>(slab + b);
}

__global__ void empty_kernel(const float4* __restrict__ x,
                             float4* __restrict__ out) {
  out[threadIdx.x] = x[threadIdx.x];
}

}  // namespace

// x (n rows of row_bytes), idx (q,) int32, out (q rows of row_bytes). The
// vector width is the widest of 16, 8, 4, 2 bytes that divides row_bytes
// and both base addresses.
extern "C" int probe_row_gather(const void* x, int n, int row_bytes,
                                const void* idx, long long q, void* out,
                                void* stream) {
  if (n < 0 || q < 0 || row_bytes <= 0 || row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t mix = (uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes;
  if (mix % 16 == 0) return launch_gather<uint4>(x, n, row_bytes, idx, q, out, s);
  if (mix % 8 == 0) return launch_gather<uint2>(x, n, row_bytes, idx, q, out, s);
  if (mix % 4 == 0) return launch_gather<uint32_t>(x, n, row_bytes, idx, q, out, s);
  return launch_gather<uint16_t>(x, n, row_bytes, idx, q, out, s);
}

// x (n rows of row_bytes, row_bytes a multiple of 16), offs (s,) int32 row
// offsets, g rows per slab. out_rows == 0: slab mode, out holds s 4-byte
// elements. out_rows > 0 (<= g): window mode, out holds s blocks of
// out_rows rows.
extern "C" int probe_slab_copy(const void* x, int n, int row_bytes,
                               const void* offs, int s, int g, int out_rows,
                               void* out, void* stream) {
  if (n < 0 || s < 0 || g <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      out_rows < 0 || out_rows > g || ((uintptr_t)x | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return (int)cudaSuccess;
  const long long bytes = (long long)g * row_bytes;
  if (bytes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slab_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();          // clear it: the next launch starts clean
      return (int)err;
    }
  }
  slab_copy_kernel<<<s, NT, (size_t)bytes, (cudaStream_t)stream>>>(
      (const char*)x, n, row_bytes, (const int*)offs, g, out_rows,
      (char*)out);
  return (int)cudaGetLastError();
}

// x and out: one (8, 128) float32 tile each.
extern "C" int probe_empty(const void* x, void* out, void* stream) {
  empty_kernel<<<1, NT, 0, (cudaStream_t)stream>>>((const float4*)x,
                                                   (float4*)out);
  return (int)cudaGetLastError();
}
