// gather_wgrad: weight gradient of the gather-matmul sparse convolution, on
// the H100's tensor cores.
//
// Has no Pallas counterpart: it replaces the XLA product of `_gm_bwd_core`
// (link_tpu/sparse/conv.py:608-622, `jnp.dot(feats.T, gk)` per tap), which
// first materialises the gathered (N, Co) copy gk = g[bwd_idx[k]] of the
// output gradient for every tap. Contract:
//
//     dW[k] = sum_i feats[i]^T (x) g[bwd_idx[k, i]]   over bwd_idx[k, i] >= 0
//
// feats (N, Ci) and g (M, Co) in one dtype (float32 or bfloat16), bwd_idx
// (K, N) int32 (the inverse kernel map: the output row that input row i
// feeds through tap k, or -1; a row >= M reads zero), dW (K, Ci, Co) float32.
//
// The kernel does not read bwd_idx itself but its work list, built once per
// plan on the device (link_tpu_torch/ops/kernels.py, `wgrad_work_list`):
// hit_i / hit_j, the (input row, output row) pairs of every hit, tap-major
// and in row order within a tap, and tap_off[k] .. tap_off[k + 1], tap k's
// range of them.
//
// What bounds it on the H100: at the training path's level-0 shape (N = M =
// 169,984, K = 27, Ci = Co = 64, float32) feats, g and the index are 105 MB,
// 0.032 ms at 3.35 TB/s, and the hits' products are ~4 GFLOP, 0.024 ms at
// the 165 TFLOP/s of float32-accurate products (3xTF32): bound by bytes.
// The earlier version ran float32 FMAs on the CUDA cores in blocks cut by
// rows, so the center tap's blocks (every row a hit) did ten times the work
// of the others (0.53 ms).
//
// Design: work cut by hits. Work item i is up to H consecutive hits of one
// tap. The scratch is sized from the shapes alone, ceil(K N / H) + K item
// slots (an upper bound of sum_k ceil(hits_k / H)); the grid is one resident
// wave of blocks, each walking items blockIdx.x, + gridDim.x, ... until the
// taps' items run out, so no host synchronisation is needed to size it.
// A block (item, 64 x 64 channel tile) stages the item's hit rows of
// feats and g in shared memory, 32 hits per stage in a ring of 2 filled
// with cp.async (a padding hit is zero-filled in both), and runs
// (Ci x 32) @ (32 x Co) per stage on mma.sync: 3xTF32 for float32, one bf16
// MMA for bfloat16 (mma_sm90.cuh), each k-step's MMAs into a fresh
// accumulator that is then added into the item's sum with a float32 add.
// Each warp holds a 16 x 32 float32 tile of that sum in registers and
// writes it once, in float64, to the item's slot of a scratch buffer. A
// second small kernel adds each tap's items in index order in float64. No
// atomics: two runs are bit-equal.
//
// Why the fresh k-step accumulators: a weight gradient can cancel hard. The
// det stem's (5 -> 16) reads the voxel means, whose intensity column sits
// near 127 on every row, against an output gradient that a BatchNorm leaves
// with a zero sum over the rows: its center tap's sum is ~1,000 times
// smaller than the sum of its products' magnitudes, so every rounding of a
// partial sum counts a thousand times. With a stage's 12 MMAs chained into
// one accumulator (the tensor core's accumulation does not round to
// nearest) the kernel missed the float64 result by 1.1-1.6e-5 of dW's
// largest entry; with a fresh accumulator for each k-step's 3 MMAs, by
// 3.3-4.9e-6, as PyTorch's float32 matmul twin (3.0-6.3e-6), at the same
// speed. The items' partials, which cancel the same way, are kept and added
// in float64. Keeping each float32 add's rounding error as well (TwoSum)
// gained little more on this data and cost 15-30% of the time.
//
// Channels past Ci / Co read whatever shared memory holds and only feed
// outputs that are dropped.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int NT = 256;      // threads per block, 8 warps of 16 x 32 outputs
constexpr int WT = 64;       // channel tile: 64 rows (Ci) x 64 columns (Co)
constexpr int RS = 32;       // hits per stage
constexpr int NSTAGE = 2;    // stages in the cp.async ring
constexpr int HMAX = 2048;   // most hits of one work item
constexpr int STR = WT + 8;  // elements per staged row: conflict-free loads

// Dynamic shared memory: T f[NSTAGE][RS][STR], T gs[NSTAGE][RS][STR],
// int hi[HMAX], int hj[HMAX].
template <typename T>
constexpr int smem_bytes() {
  return 2 * NSTAGE * RS * STR * (int)sizeof(T) + 2 * HMAX * 4;
}

template <typename T>
__global__ void __launch_bounds__(NT)
gather_wgrad_kernel(const T* __restrict__ feats, int ci,
                    const T* __restrict__ g, int m, int co,
                    const int* __restrict__ hit_i,
                    const int* __restrict__ hit_j,
                    const int* __restrict__ tap_off, int k, int per_item,
                    int co_tiles, double* __restrict__ partial, int vec_f,
                    int vec_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* fs = reinterpret_cast<T*>(smem);
  T* gs = fs + NSTAGE * RS * STR;
  int* hi = reinterpret_cast<int*>(gs + NSTAGE * RS * STR);
  int* hj = hi + HMAX;
  __shared__ int s_tap, s_h0, s_h1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 16;   // the warp's rows (Ci) in the tile
  const int wn = (warp & 1) * 32;    // and columns (Co)
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int c0 = (blockIdx.y / co_tiles) * WT;   // first Ci of the tile
  const int n0 = (blockIdx.y % co_tiles) * WT;   // first Co of the tile
  const int fw = min(WT, ci - c0);               // valid channels
  const int gw = min(WT, co - n0);
  const RowCopy copy_f{vec_f}, copy_g{vec_g};
  const int f_row = ci * (int)sizeof(T), g_row = co * (int)sizeof(T);
  const int f_vpr = fw * (int)sizeof(T) / vec_f;
  const int g_vpr = gw * (int)sizeof(T) / vec_g;

  // The block walks the items blockIdx.x, + gridDim.x, ... while they exist.
  for (int item = blockIdx.x;; item += gridDim.x) {
    // 1. The item's tap and hits: warp 0 scans the per-tap item counts, 32
    // taps at a time.
    if (warp == 0) {
      if (lane == 0) s_tap = -1;
      __syncwarp();
      int base = 0;
      for (int kb = 0; kb < k; kb += 32) {
        const int kk = kb + lane;
        int lo = 0, end = 0, items = 0;
        if (kk < k) {
          lo = tap_off[kk];
          end = tap_off[kk + 1];
          items = (end - lo + per_item - 1) / per_item;
        }
        int inc = items;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, d);
          if (lane >= d) inc += y;
        }
        const int start = base + inc - items;
        if (kk < k && item >= start && item < start + items) {
          s_tap = kk;
          s_h0 = lo + (item - start) * per_item;
          s_h1 = min(s_h0 + per_item, end);
        }
        base += __shfl_sync(0xffffffffu, inc, 31);
      }
    }
    __syncthreads();
    if (s_tap < 0) return;
    const int h0 = s_h0;
    const int nhit = s_h1 - s_h0;
    for (int e = tid; e < nhit; e += NT) {
      hi[e] = hit_i[h0 + e];
      const int j = hit_j[h0 + e];
      hj[e] = (j >= 0 && j < m) ? j : -1;
    }
    __syncthreads();

    // 2. Stages of RS hits: rows of feats (channels c0..) and g (n0..);
    // a padding hit reads nothing and stages zeros.
    const int nstages = (nhit + RS - 1) / RS;
    auto issue = [&](int s, int buf) {
      char* fd = reinterpret_cast<char*>(fs + buf * RS * STR);
      char* gd = reinterpret_cast<char*>(gs + buf * RS * STR);
      for (int e = tid; e < RS * f_vpr; e += NT) {
        const int r = e / f_vpr;
        const int off = (e - r * f_vpr) * vec_f;
        const int h = s * RS + r;
        const bool read = h < nhit;
        const char* gp = reinterpret_cast<const char*>(feats) +
                         (read ? (long long)hi[h] * f_row + c0 * (int)sizeof(T) + off
                               : 0);
        copy_f.piece(fd + r * STR * (int)sizeof(T) + off, gp, read);
      }
      for (int e = tid; e < RS * g_vpr; e += NT) {
        const int r = e / g_vpr;
        const int off = (e - r * g_vpr) * vec_g;
        const int h = s * RS + r;
        const bool read = h < nhit && hj[h] >= 0;
        const char* gp = reinterpret_cast<const char*>(g) +
                         (read ? (long long)hj[h] * g_row + n0 * (int)sizeof(T) + off
                               : 0);
        copy_g.piece(gd + r * STR * (int)sizeof(T) + off, gp, read);
      }
    };

    for (int i = 0; i < NSTAGE - 1; ++i) {
      if (i < nstages) issue(i, i);
      cp_async_commit();
    }

    // c: the item's sum; e: one k-step's MMAs from zero (mma_sm90.cuh: a
    // chain of MMA accumulations drifts), added into c.
    float c[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[nt][q] = 0.f;

    for (int s = 0; s < nstages; ++s) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      if (s + NSTAGE - 1 < nstages)
        issue(s + NSTAGE - 1, (s + NSTAGE - 1) % NSTAGE);
      cp_async_commit();

      const T* f = fs + (s % NSTAGE) * RS * STR;
      const T* gg = gs + (s % NSTAGE) * RS * STR;
      if constexpr (sizeof(T) == 4) {
        // A (Ci x hits) = f^T, B (hits x Co) = gg; k-steps of 8 hits
#pragma unroll
        for (int ks = 0; ks < RS / 8; ++ks) {
          const float* fr =
              reinterpret_cast<const float*>(f) + (ks * 8 + t) * STR;
          const float* gr =
              reinterpret_cast<const float*>(gg) + (ks * 8 + t) * STR;
          const int col = wm + gq;
          const float x[4] = {fr[col], fr[col + 8], fr[4 * STR + col],
                              fr[4 * STR + col + 8]};
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[q], al[q]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int cn = wn + nt * 8 + gq;
            split_tf32(gr[cn], bh[nt][0], bl[nt][0]);
            split_tf32(gr[4 * STR + cn], bh[nt][1], bl[nt][1]);
          }
          if (wm < fw) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (wn + nt * 8 >= gw) break;
              float e[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(e, ah, al, bh[nt][0], bh[nt][1], bl[nt][0],
                         bl[nt][1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) c[nt][q] += e[q];
            }
          }
        }
      } else {
        // k-steps of 16 hits; fragments by ldmatrix.trans from the
        // row-major staged rows (lanes 8q..8q+7 address matrix q's rows)
        const int q = lane >> 3;
        const int r = lane & 7;
#pragma unroll
        for (int ks = 0; ks < RS / 16; ++ks) {
          uint32_t a[4], b[2][4];
          ldmatrix_x4_trans(a, f + (ks * 16 + (q >> 1) * 8 + r) * STR + wm +
                                   (q & 1) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np)
            ldmatrix_x4_trans(b[np], gg + (ks * 16 + (q & 1) * 8 + r) * STR +
                                         wn + np * 16 + (q >> 1) * 8);
          if (wm < fw) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (wn + nt * 8 >= gw) break;
              float e[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(e, a, b[nt >> 1][(nt & 1) * 2],
                       b[nt >> 1][(nt & 1) * 2 + 1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) c[nt][q] += e[q];
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    // 3. The item's partial tile, written once to its own slot.
    double* out = partial + (long long)item * ci * co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + gq + 8 * h;
      if (row >= fw) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn + nt * 8 + 2 * t + e;
          if (col < gw)
            out[(long long)(c0 + row) * co + n0 + col] = c[nt][2 * h + e];
        }
    }
    __syncthreads();   // the shared buffers and s_tap are reused
  }
}

// dw[tap][e] = sum of the tap's items' partial[item][e], items in index
// order, in float64 (0 for a tap without a hit).
__global__ void wgrad_reduce_kernel(const double* __restrict__ partial,
                                    const int* __restrict__ tap_off, int k,
                                    int per_item, int cc,
                                    float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)k * cc) return;
  const int tap = (int)(e / cc);
  const int within = (int)(e % cc);
  int first = 0;
  for (int kk = 0; kk < tap; ++kk)
    first += (tap_off[kk + 1] - tap_off[kk] + per_item - 1) / per_item;
  const int items = (tap_off[tap + 1] - tap_off[tap] + per_item - 1) / per_item;
  double s = 0.0;
#pragma unroll 8
  for (int it = first; it < first + items; ++it)
    s += partial[(long long)it * cc + within];
  dw[e] = (float)s;
}

// ---------------------------------------------------------------- work list
//
// Three small kernels build the work list of bwd_idx (K, N) once per plan:
// hits counted per (tap, 1,024-row chunk), the counts scanned in tap-major
// order into offsets (one block), and each chunk's hits written at its
// offset in row order (block-wide ballot prefix). Deterministic, no atomics.

constexpr int LT = 256;              // threads of the list kernels
constexpr int LROWS = 4 * LT;        // rows per chunk

// hits of rows r .. r + LT - 1 of one tap before this thread's row (in row
// order) and in all; smem holds LT / 32 ints
__device__ __forceinline__ int block_prefix(bool hit, int* warp_cnt,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned vote = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_cnt[warp] = __popc(vote);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < LT / 32; ++w) {
    const int c = warp_cnt[w];
    if (w < warp) before += c;
    total += c;
  }
  __syncthreads();
  return before + __popc(vote & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(LT)
list_count_kernel(const int* __restrict__ bwd_idx, int n, int chunks,
                  int* __restrict__ counts) {
  __shared__ int warp_cnt[LT / 32];
  const int tap = blockIdx.y;
  const int* idx = bwd_idx + (long long)tap * n;
  int sum = 0;
  for (int j = 0; j < 4; ++j) {
    const int row = blockIdx.x * LROWS + j * LT + threadIdx.x;
    int total;
    block_prefix(row < n && idx[row] >= 0, warp_cnt, total);
    sum += total;
  }
  if (threadIdx.x == 0) counts[tap * chunks + blockIdx.x] = sum;
}

// offs = exclusive scan of counts (tap-major); tap_off[k] = offs[k chunks],
// tap_off[K] = the total. One block of LT threads.
__global__ void __launch_bounds__(LT)
list_scan_kernel(const int* __restrict__ counts, int k, int chunks,
                 int* __restrict__ offs, int* __restrict__ tap_off) {
  __shared__ int warp_sum[LT / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_all = k * chunks;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int e0 = 0; e0 < e_all; e0 += LT) {
    const int e = e0 + threadIdx.x;
    const int v = e < e_all ? counts[e] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (e < e_all) {
      offs[e] = before + inc - v;
      if (e % chunks == 0) tap_off[e / chunks] = before + inc - v;
    }
    __syncthreads();
    if (threadIdx.x == LT - 1) carry = before + inc;
    __syncthreads();
  }
  if (threadIdx.x == 0) tap_off[k] = carry;
}

__global__ void __launch_bounds__(LT)
list_write_kernel(const int* __restrict__ bwd_idx, int n, int chunks,
                  const int* __restrict__ offs, int* __restrict__ hit_i,
                  int* __restrict__ hit_j) {
  __shared__ int warp_cnt[LT / 32];
  const int tap = blockIdx.y;
  const int* idx = bwd_idx + (long long)tap * n;
  int at = offs[tap * chunks + blockIdx.x];
  for (int j = 0; j < 4; ++j) {
    const int row = blockIdx.x * LROWS + j * LT + threadIdx.x;
    const int v = row < n ? idx[row] : -1;
    int total;
    const int pos = block_prefix(v >= 0, warp_cnt, total);
    if (v >= 0) {
      hit_i[at + pos] = row;
      hit_j[at + pos] = v;
    }
    at += total;
  }
}

template <typename T>
int launch(const void* feats, int ci, const void* g, int m, int co,
           const void* hit_i, const void* hit_j, const void* tap_off, int k,
           int per_item, int items, void* partial, void* dw,
           cudaStream_t stream) {
  static int granted = 0;
  const auto kern = gather_wgrad_kernel<T>;
  cudaError_t err = allow_smem(kern, smem_bytes<T>(), granted);
  if (err != cudaSuccess) return (int)err;
  // at most one resident wave of blocks; each walks items by gridDim.x
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                  smem_bytes<T>());
    resident = max(1, sms * per_sm);
  }
  const int ci_tiles = (ci + WT - 1) / WT;
  const int co_tiles = (co + WT - 1) / WT;
  const dim3 grid(min(items, max(1, resident / (ci_tiles * co_tiles))),
                  ci_tiles * co_tiles);
  kern<<<grid, NT, smem_bytes<T>(), stream>>>(
      (const T*)feats, ci, (const T*)g, m, co, (const int*)hit_i,
      (const int*)hit_j, (const int*)tap_off, k, per_item, co_tiles,
      (double*)partial, copy_vec(feats, (long long)ci * sizeof(T)),
      copy_vec(g, (long long)co * sizeof(T)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)k * ci * co;
  wgrad_reduce_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(
      (const double*)partial, (const int*)tap_off, k, per_item, ci * co,
      (float*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// The work list of bwd_idx (k, n) int32: hit_i, hit_j (k n int32) and
// tap_off (k + 1 int32) as `gather_wgrad` reads them; `counts` and `offs`
// are scratch of k * ceil(n / 1024) ints. Three launches.
extern "C" int wgrad_work_list(const void* bwd_idx, int n, int k,
                               void* hit_i, void* hit_j, void* tap_off,
                               void* counts, void* offs, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (n + LROWS - 1) / LROWS;
  const dim3 grid(chunks, k);
  list_count_kernel<<<grid, LT, 0, s>>>((const int*)bwd_idx, n, chunks,
                                        (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  list_scan_kernel<<<1, LT, 0, s>>>((const int*)counts, k, chunks,
                                    (int*)offs, (int*)tap_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  list_write_kernel<<<grid, LT, 0, s>>>((const int*)bwd_idx, n, chunks,
                                        (const int*)offs, (int*)hit_i,
                                        (int*)hit_j);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (feats and g). hit_i, hit_j (K N int32)
// and tap_off (K + 1 int32) are the work list of bwd_idx; `per_item` (at
// most 2048) hits make one work item; `partial` is scratch of `items` * ci *
// co floats with items >= ceil(K N / per_item) + K; `dw` receives (k, ci,
// co) floats. All pointers are device pointers; `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launches.
extern "C" int gather_wgrad(const void* feats, int n, int ci, const void* g,
                            int m, int co, const void* hit_i,
                            const void* hit_j, const void* tap_off, int k,
                            int per_item, int items, void* partial, void* dw,
                            int dtype, void* stream) {
  if (n <= 0 || k <= 0 || ci <= 0 || co <= 0 || per_item <= 0 ||
      per_item > HMAX ||
      (long long)items < ((long long)k * n + per_item - 1) / per_item + k)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, ci, g, m, co, hit_i, hit_j, tap_off, k,
                         per_item, items, partial, dw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, ci, g, m, co, hit_i, hit_j, tap_off,
                                 k, per_item, items, partial, dw, s);
  return (int)cudaErrorInvalidValue;
}
