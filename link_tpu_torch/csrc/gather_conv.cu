// gather_conv: gather-matmul sparse convolution over a kernel map, on the
// H100's tensor cores.
//
// Replaces the Pallas kernel `pallas_sparse_conv` (link_tpu/ops/
// pallas_kernels.py:111-144, body `_conv_kernel` :92-108). Same contract:
//
//     out[m] = sum_k feats[idx[k, m]] @ W[k]   (idx < 0 or >= N reads zero)
//
// feats (N, Ci), idx (K, M) int32, W (K, Ci, Co), out (M, Co), all in one
// dtype (float32 or bfloat16); the sum accumulates in float32 and is rounded
// to the feature dtype once, at the single write of each output.
//
// What bounds it on the H100: at the seg path's shapes (K = 27, Ci = Co =
// 64, M = 84,992 rows, 10.6% of the (tap, row) slots hit) the hit products
// are ~2 GFLOP against ~53 MB of input and output: at 3.35 TB/s and 165
// TFLOP/s for float32-accurate products (3xTF32, a third of the 495 TFLOP/s
// TF32 rate) it is bound by bytes, 0.016 ms. The first version ran float32
// FMAs on the CUDA cores over whole 64-row tiles, misses included (4.6x the
// needed work, 0.57 ms). What this one moves beyond the bound is W: every
// (tile, tap) pair with a hit reads its Ci x 64 slice of W[tap] from L2
// again, ~13 taps per 64-row tile, several times the bytes of the gathered
// rows (link_tpu_torch/tools/conv_phases.py counts them and times each
// phase).
//
// Design (output-stationary, hits compacted per (tile, tap)):
//   * One block of 4 warps owns TM (64) output rows x 64 output channels
//     and keeps their float32 sums in shared memory.
//   * Each warp compacts whole taps of the tile (up to 32 taps at a time):
//     it loads the indices of all its taps at once (one memory round trip,
//     not one per tap), then writes the hit rows in row order, padded to row
//     tiles of 16 (warp ballot and prefix, no block-wide pass), into one
//     list over the taps in order.
//   * The list is cut into stages of 4 row tiles x 64 input channels, which
//     may mix taps; a ring of 2 stages is filled with cp.async (zero-filled
//     past Ci), so the next stage's gathers fly while one multiplies.
//   * Each warp owns 16 output channels: for each row tile it loads its B
//     fragments of W[tap] when the tap changes, runs mma.sync over the tile
//     (3xTF32 for float32, one bf16 MMA for bfloat16; mma_sm90.cuh) and adds
//     each result row into the accumulator at its output row. A warp adds
//     its row tiles in tap order (__syncwarp between them), warps own
//     disjoint channels, and stages are separated by a barrier: no races,
//     and the result does not depend on scheduling.
//   * The B fragments come from a copy of W in fragment order, written by a
//     small kernel launched before the conv (`w_frag_kernel`, into the
//     caller's scratch): a lane's four B registers of one k-step are one
//     16-byte load, where W's own layout takes four 4-byte loads of four
//     rows. The W reads are the kernel's most numerous memory instructions,
//     and fewer of them leave the load pipeline to the row gathers.
//   * The tile is written once at the end. Taps with no hit cost nothing.
// Ragged widths: Ci is zero-padded in shared memory to the MMA's depth (8
// for tf32, 16 for bf16), the W copy is zero past Ci and Co, and output
// channels past Co are dropped; Co > 64 takes more blocks along grid.y.
// The host side launches grids sized by the shapes alone: no
// synchronisation and nothing sized from the data.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TM = 64;           // output rows per block
constexpr int TN = 64;           // output channels per block, 16 per warp
constexpr int KC = 64;           // input channels per stage
constexpr int MT = 16;           // rows of one MMA tile
constexpr int GT = 4;            // MMA row tiles per stage
constexpr int SR = GT * MT;      // rows per stage
constexpr int NSTAGE = 2;        // stages in the cp.async ring
constexpr int KB = 32;           // taps compacted at a time
constexpr int ACC_STR = TN + 8;  // floats per accumulator row

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int KSTEP = 8;       // m16n8k8 tf32
  static constexpr int ASTR = KC + 4;   // conflict-free fragment loads
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int KSTEP = 16;      // m16n8k16 bf16
  static constexpr int ASTR = KC + 8;
};

// Dynamic shared memory layout, byte offsets: float acc[TM][ACC_STR],
// T a[NSTAGE][SR][ASTR], int src[KB * TM] (the input row of every row of
// every row tile, -1 past a tile's hits), u8 lrow[KB * TM] (the tile row of
// each), int tiles[KB * TM / MT] (tap | hits << 8 per row tile), int
// nh[KB] (hits per tap), int ntiles.
template <typename T>
struct Smem {
  static constexpr int acc = 0;
  static constexpr int a = acc + TM * ACC_STR * 4;
  static constexpr int src = a + NSTAGE * SR * Op<T>::ASTR * (int)sizeof(T);
  static constexpr int lrow = src + (KB * TM + KB * MT) * 4;
  static constexpr int tiles = lrow + KB * TM + KB * MT;
  static constexpr int nh = tiles + (KB * TM / MT + KB) * 4;
  static constexpr int ntiles = nh + KB * 4;
  static constexpr int bytes = ntiles + 16;
};

// Built with -DGATHER_CONV_PHASES (link_tpu_torch/tools/conv_phases.py),
// the kernel also counts, in warp 1, the SM clock cycles of each phase and
// the stages of every block; `gather_conv_phases` copies them out.
#ifdef GATHER_CONV_PHASES
constexpr int NPHASE = 8;   // compact, wait, issue, compute, flush, store,
                            // total, stages
constexpr int PHASE_BLOCKS = 1 << 16;
__device__ long long phase_cycles[PHASE_BLOCKS * NPHASE];
#define PHASE_START                                  \
  long long ph_t = clock64(), ph_0 = ph_t;           \
  long long ph[NPHASE] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PHASE_MARK(i)                                \
  {                                                  \
    const long long now = clock64();                 \
    ph[i] += now - ph_t;                             \
    ph_t = now;                                      \
  }
#define PHASE_COUNT_STAGE ++ph[7];
#define PHASE_END                                                     \
  if (threadIdx.x == 32 && blockIdx.x + blockIdx.y * gridDim.x <      \
                               (unsigned)PHASE_BLOCKS) {              \
    ph[6] = clock64() - ph_0;                                         \
    long long* q = phase_cycles +                                     \
        (long long)(blockIdx.x + blockIdx.y * gridDim.x) * NPHASE;     \
    for (int i = 0; i < NPHASE; ++i) q[i] = ph[i];                    \
  }
#else
#define PHASE_START
#define PHASE_MARK(i)
#define PHASE_COUNT_STAGE
#define PHASE_END
#endif

template <typename T>
__global__ void __launch_bounds__(NT, 3)
gather_conv_kernel(const T* __restrict__ feats, int n, int ci,
                   const int* __restrict__ idx, int k, int m,
                   const uint4* __restrict__ wf, int co,
                   T* __restrict__ out, int vec) {
  using L = Smem<T>;
  constexpr int KSTEP = Op<T>::KSTEP;
  constexpr int ASTR = Op<T>::ASTR;
  constexpr int KS = KC / KSTEP;   // MMA k-steps per stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  T* abuf = reinterpret_cast<T*>(smem + L::a);
  int* src = reinterpret_cast<int*>(smem + L::src);
  unsigned char* lrow = smem + L::lrow;
  int* tiles = reinterpret_cast<int*>(smem + L::tiles);
  int* nh = reinterpret_cast<int*>(smem + L::nh);
  int* ntiles = reinterpret_cast<int*>(smem + L::ntiles);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int wc = warp * 16;          // the warp's first channel in the tile
  const bool wlive = n0 + wc < co;
  const RowCopy copy{vec};
  const int row_bytes = ci * (int)sizeof(T);
  const int nchunk = (ci + KC - 1) / KC;
  PHASE_START

  for (int e = tid * 4; e < TM * ACC_STR; e += NT * 4)
    *reinterpret_cast<float4*>(acc + e) = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < k; k0 += KB) {
    const int kb = min(KB, k - k0);

    // 1. Each warp compacts whole taps (kk = warp + j * NWARP): the hits of
    // the tile's rows, in row order, padded to row tiles of 16. A tap's rows
    // start at its first row tile * 16 in src / lrow. First the indices of
    // all the warp's taps (loaded together) and their hit counts, then the
    // row tiles' places, then the rows.
    constexpr int RPL = TM / 32;     // tile rows per lane
    constexpr int TPW = (KB + NWARP - 1) / NWARP;   // taps per warp
    int v[TPW][RPL];                 // the index, -1 for a miss
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int kk = warp + j * NWARP;
      const int* ik = idx + (long long)(k0 + kk) * m + m0;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = q * 32 + lane;
        const int x = (kk < kb && m0 + r < m) ? ik[r] : -1;
        v[j][q] = x < n ? x : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int kk = warp + j * NWARP;
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < RPL; ++q)
        cnt += __popc(__ballot_sync(0xffffffffu, v[j][q] >= 0));
      if (lane == 0 && kk < kb) nh[kk] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
      // row tiles per tap, scanned over the taps (kb <= 32: one per lane)
      const int mine = lane < kb ? (nh[lane] + MT - 1) / MT : 0;
      int inc = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
      }
      const int first = inc - mine;
      for (int u = 0; u < mine; ++u)
        tiles[first + u] = lane | min(MT, nh[lane] - u * MT) << 8;
      if (lane == 31) *ntiles = inc;
      // the tap's first row in src / lrow, kept in nh's place from here on
      __syncwarp();
      if (lane < kb) nh[lane] = first * MT;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int kk = warp + j * NWARP;
      if (kk >= kb) break;
      const int base = nh[kk];
      int before = 0;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = q * 32 + lane;
        const unsigned vote = __ballot_sync(0xffffffffu, v[j][q] >= 0);
        if (v[j][q] >= 0) {
          const int pos = base + before + __popc(vote & ((1u << lane) - 1u));
          src[pos] = v[j][q];
          lrow[pos] = (unsigned char)r;
        }
        before += __popc(vote);
      }
      // pad the tap's last row tile with -1 (no gather)
      const int end = (before + MT - 1) / MT * MT;
      for (int p = before + lane; p < end; p += 32) src[base + p] = -1;
    }
    __syncthreads();

    PHASE_MARK(0)
    // 2. Stages: GT row tiles (of any taps) x one chunk of KC channels,
    // chunks inner. Each warp walks the stage's row tiles in order.
    const int nt_all = *ntiles;
    const int nstages = (nt_all + GT - 1) / GT * nchunk;
    // gather a stage's rows: each warp copies rows, its lanes the pieces of
    // a row (zero-filled from Ci to the MMA depth; padding rows are left as
    // they are: their products are dropped)
    auto issue = [&](int s, int buf) {
      const int c0 = s % nchunk * KC;
      const int kc = min(KC, ci - c0);
      const int vpr = (kc + KSTEP - 1) / KSTEP * KSTEP * (int)sizeof(T) / vec;
      const int rpi = max(1, 32 / vpr);          // rows per warp pass
      const int lr = lane / vpr;
      const int cbytes = c0 * (int)sizeof(T);
      char* dst = reinterpret_cast<char*>(abuf + buf * SR * ASTR);
      const int r0 = s / nchunk * SR;            // first row of the stage
      const int rows = min(SR, nt_all * MT - r0);
      for (int rr = warp * rpi; rr < rows; rr += NWARP * rpi) {
        const int r = rr + lr;
        if (lr >= rpi || r >= rows) continue;
        const int row = src[r0 + r];
        if (row < 0) continue;
        for (int p = lane - lr * vpr; p < vpr; p += 32) {
          const int off = cbytes + p * vec;
          const bool read = off < row_bytes;
          const char* gp = reinterpret_cast<const char*>(feats) +
                           (long long)row * row_bytes + (read ? off : 0);
          copy.piece(dst + r * ASTR * (int)sizeof(T) + p * vec, gp, read);
        }
      }
    };
    // The warp's B fragments of W[tap] (channels c0.., its 16 output
    // channels) from the fragment-ordered copy: one 16-byte load per k-step.
    auto load_b = [&](int tap, int c0, uint32_t (&b)[KS][2][2]) {
      const int ksteps = (min(KC, ci - c0) + KSTEP - 1) / KSTEP;
      const uint4* f = wf + ((((long long)(k0 + tap) * nchunk + c0 / KC) *
                                  gridDim.y + blockIdx.y) * NWARP + warp) *
                                KS * 32 + lane;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint4 q = ks < ksteps ? f[ks * 32] : make_uint4(0, 0, 0, 0);
        b[ks][0][0] = q.x;
        b[ks][0][1] = q.y;
        b[ks][1][0] = q.z;
        b[ks][1][1] = q.w;
      }
    };

    for (int i = 0; i < NSTAGE - 1; ++i) {
      if (i < nstages) issue(i, i);
      cp_async_commit();
    }

    float c[GT][2][4];                     // row tile x n-tile sums
    uint32_t b[KS][2][2];                  // B of (btap, bc0)
    int btap = -1, bc0 = -1;
    for (int s = 0; s < nstages; ++s) {
      const int buf = s % NSTAGE;
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      PHASE_MARK(1)
      if (s + NSTAGE - 1 < nstages)
        issue(s + NSTAGE - 1, (s + NSTAGE - 1) % NSTAGE);
      cp_async_commit();
      PHASE_MARK(2)
      PHASE_COUNT_STAGE
      if (!wlive) continue;

      const int c0 = s % nchunk * KC;
      const int ksteps = (min(KC, ci - c0) + KSTEP - 1) / KSTEP;
      const int u0 = s / nchunk * GT;
      const int nu = min(GT, nt_all - u0);
      if (c0 == 0) {
#pragma unroll
        for (int u = 0; u < GT; ++u)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) c[u][nt][q] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < GT; ++u) {
        if (u >= nu) break;
        const int tap = tiles[u0 + u] & 0xff;
        if (tap != btap || c0 != bc0) {
          load_b(tap, c0, b);
          btap = tap;
          bc0 = c0;
        }
        const T* a = abuf + (buf * SR + u * MT) * ASTR;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= ksteps) break;
          if constexpr (KSTEP == 8) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                split_tf32(__uint_as_float(b[ks][nt][h]), bh[nt][h], bl[nt][h]);
            const float* ar = reinterpret_cast<const float*>(a) + g * ASTR +
                              ks * 8 + t;
            const float x[4] = {ar[0], ar[8 * ASTR], ar[4], ar[8 * ASTR + 4]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[q], al[q]);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_3xtf32(c[u][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0],
                         bl[nt][1]);
          } else {
            const uint32_t* ar = reinterpret_cast<const uint32_t*>(
                a + g * ASTR + ks * 16) + t;
            const uint32_t x[4] = {ar[0], ar[4 * ASTR], ar[4], ar[4 * ASTR + 4]};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_bf16(c[u][nt], x, b[ks][nt][0], b[ks][nt][1]);
          }
        }
      }
      PHASE_MARK(3)
      if (c0 + KC >= ci) {
        // add the row tiles into the accumulator at their tile rows, in tap
        // order (rows of two taps may meet: lanes of one warp, so __syncwarp)
#pragma unroll
        for (int u = 0; u < GT; ++u) {
          if (u >= nu) break;
          const int rows = tiles[u0 + u] >> 8;
          const unsigned char* lr = lrow + (u0 + u) * MT;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = g + 8 * h;
            if (j < rows) {
              float* p = acc + lr[j] * ACC_STR + wc + 2 * t;
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                p[nt * 8] += c[u][nt][2 * h];
                p[nt * 8 + 1] += c[u][nt][2 * h + 1];
              }
            }
          }
          __syncwarp();
        }
      }
      PHASE_MARK(4)
    }
    cp_async_wait<0>();
    __syncthreads();
    PHASE_MARK(1)
  }

  // 3. The tile, written once (four channels a thread where Co allows).
  if constexpr (sizeof(T) == 4) {
    if (co % 4 == 0) {
      for (int e = tid * 4; e < TM * TN; e += NT * 4) {
        const int r = e / TN;
        const int col = e % TN;
        if (m0 + r < m && n0 + col < co)
          *reinterpret_cast<float4*>(out + (long long)(m0 + r) * co + n0 + col) =
              *reinterpret_cast<const float4*>(acc + r * ACC_STR + col);
      }
      PHASE_MARK(5)
      PHASE_END
      return;
    }
  }
  for (int e = tid; e < TM * TN; e += NT) {
    const int r = e / TN;
    const int col = e % TN;
    if (m0 + r < m && n0 + col < co)
      store(out + (long long)(m0 + r) * co + n0 + col, acc[r * ACC_STR + col]);
  }
  PHASE_MARK(5)
  PHASE_END
}

// W in the order of the B fragments: for (tap, Ci chunk, 64-column tile,
// warp, k-step, lane), the lane's four 32-bit B registers b[nt][h] (k rows
// t, t + 4 of tf32; pairs 2t, 2t + 8 of bf16; columns g, g + 8 of the
// warp's 16), zero past Ci and Co. NWARP * KS * 32 * 16 bytes per
// (tap, chunk, tile).
template <typename T>
__global__ void w_frag_kernel(const T* __restrict__ w, int k, int ci, int co,
                              int nchunk, int ntile, uint4* __restrict__ wf) {
  constexpr int KSTEP = Op<T>::KSTEP;
  constexpr int KS = KC / KSTEP;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)k * nchunk * ntile * NWARP * KS * 32;
  if (e >= total) return;
  const int lane = (int)(e % 32);
  const int ks = (int)(e / 32 % KS);
  const int warp = (int)(e / (32 * KS) % NWARP);
  const int tile = (int)(e / (32 * KS * NWARP) % ntile);
  const int ch = (int)(e / (32 * KS * NWARP * ntile) % nchunk);
  const int tap = (int)(e / (32LL * KS * NWARP * ntile * nchunk));
  const int g = lane >> 2, t = lane & 3;
  const T* wk = w + (long long)tap * ci * co;
  uint32_t r[4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = tile * TN + warp * 16 + nt * 8 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (KSTEP == 8) {
        const int kr = ch * KC + ks * 8 + t + 4 * h;
        const float x = (kr < ci && col < co) ? to_f32(wk[(long long)kr * co + col])
                                              : 0.f;
        r[nt * 2 + h] = __float_as_uint(x);
      } else {
        const int kr = ch * KC + ks * 16 + 2 * t + 8 * h;
        const T zero = __float2bfloat16(0.f);
        const T lo = (kr < ci && col < co) ? wk[(long long)kr * co + col] : zero;
        const T hi = (kr + 1 < ci && col < co) ? wk[(long long)(kr + 1) * co + col]
                                                : zero;
        r[nt * 2 + h] = pack_bf16(lo, hi);
      }
    }
  }
  wf[e] = make_uint4(r[0], r[1], r[2], r[3]);
}

template <typename T>
int launch(const void* feats, int n, int ci, const void* idx, int k, int m,
           const void* w, int co, void* wf, void* out, cudaStream_t stream) {
  using L = Smem<T>;
  static int granted = 0;
  const auto kern = gather_conv_kernel<T>;
  const cudaError_t e = allow_smem(kern, L::bytes, granted);
  if (e != cudaSuccess) return (int)e;
  const int vec = copy_vec(feats, (long long)ci * sizeof(T));
  const dim3 grid((m + TM - 1) / TM, (co + TN - 1) / TN);
  constexpr int KS = KC / Op<T>::KSTEP;
  const int nchunk = (ci + KC - 1) / KC;
  const long long frags = (long long)k * nchunk * grid.y * NWARP * KS * 32;
  w_frag_kernel<T><<<(unsigned)((frags + 255) / 256), 256, 0, stream>>>(
      (const T*)w, k, ci, co, nchunk, grid.y, (uint4*)wf);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  kern<<<grid, NT, L::bytes, stream>>>((const T*)feats, n, ci,
                                       (const int*)idx, k, m,
                                       (const uint4*)wf, co, (T*)out, vec);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef GATHER_CONV_PHASES
// The phase counts of the last launch's first `blocks` blocks, NPHASE each,
// copied to host memory `dst`.
extern "C" int gather_conv_phases(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(
      dst, phase_cycles, sizeof(long long) * NPHASE * min(blocks, PHASE_BLOCKS));
}
#endif

// dtype: 0 = float32, 1 = bfloat16. `w_frag` is scratch of K *
// ceil(Ci / 64) * ceil(Co / 64) * 16384 (float32) or 8192 (bfloat16) bytes
// for W in fragment order. All pointers are device pointers; `stream` is a
// cudaStream_t. Two launches (W's copy, the conv); returns
// cudaGetLastError() after them.
extern "C" int gather_conv(const void* feats, int n, int ci, const void* idx,
                           int k, int m, const void* w, int co, void* w_frag,
                           void* out, int dtype, void* stream) {
  if (m <= 0 || co <= 0 || ci <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, n, ci, idx, k, m, w, co, w_frag, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, n, ci, idx, k, m, w, co, w_frag, out,
                                 s);
  return (int)cudaErrorInvalidValue;
}
