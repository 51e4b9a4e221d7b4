// window_conv: window-form sparse convolution over a sorted-row plan, on the
// H100's tensor cores.
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
// `goff[g] .. goff[g+1]` bounds group g's entries. A slot at or past the
// window width `gw`, or a row at or past N, reads zero. The sum accumulates
// in float32 and is rounded to the feature dtype once, at the single write
// of each output; no atomics, so two runs give the same bits.
//
// What bounds it on the H100: at the det backbone's level 0 (M = N =
// 163,840, Gg = 9 groups of G = 3 taps, Ci = Co = 16, float32) the function
// moves ~31 MB (feats, base_pos, slot, W and out, each once: 0.0093 ms at
// 3.35 TB/s) for ~0.1 GFLOP of hit products: bound by bytes. The level is
// sparse: 1.18 hits per voxel, and a 16-row tile has a hit in ~3 of its 9
// groups.
//
// The TPU kernel's idea, kept here: rows are sorted, so for one group the
// base rows of consecutive output rows are nondecreasing, and the rows a
// tile reads for that group are one short contiguous span of the table. The
// TPU kernel DMAs two slabs and builds a one-hot matmul (Mosaic has no
// in-VMEM gather); on Hopper the span is copied into shared memory with
// cp.async and the slots are routed from it into the MMA's A fragments.
//
// Design:
//   * A block of up to 16 warps (as many as shared memory holds) stages W
//     once, as the group-stacked, transposed Wt[g][n][j * CiP + c] =
//     W[groups[g][j]][c][n0 + n] for its 16 output columns (zero past Ci,
//     past the group's taps and past Co; CiP = Ci rounded up to the MMA
//     depth), and keeps it for every tile it takes: the grid is sized to
//     the blocks the card holds at once, and each warp walks 16-row output
//     tiles (warp w takes tiles w, w + W, ...).
//   * A tile's base rows (all groups) and slots (all taps) arrive by 16-byte
//     cp.async, requested while the tile before computes. The warp then
//     marks which taps and groups hit in the tile (one 16-byte slot row per
//     lane, its bytes compared at once) and walks only the groups with a
//     hit, with a double-buffered span ring: while group g multiplies, the
//     next group's span [min base, max base + gw - 1] over the rows with a
//     hit (at most S = 48 rows) is in flight as cp.async of 16 bytes a
//     piece, or 8 or 4 where the row pitch asks for it (Ci = 5 float32 rows
//     are 20 bytes apart), zero-filled from Ci to CiP. Rows of odd-width
//     bfloat16 (Ci = 5: 10 bytes apart) are copied as the 4-byte words that
//     cover them, the row starting 0 or 2 bytes into its slot. Only the
//     warp's own lanes read its spans: __syncwarp, no block barrier after
//     W is staged.
//   * A window row outside the staged span (a span longer than S, or bases
//     out of order) is copied from device memory into the warp's overflow
//     rows inside the kernel; a miss reads a zero row kept past the span.
//     The result is right whatever the data: no overflow flag, no host
//     sync, no exit to another kernel, so link_tpu's `window_starts` /
//     `window_overflow` have no counterpart here.
//   * Each lane routes its two rows' slots to their span rows and loads its
//     A fragments from there; `mma.sync` multiplies them with the group's
//     stacked Wt: depth G * CiP, as m16n8k8 3xTF32 for float32 and m16n8k16
//     bf16 for bfloat16 (mma_sm90.cuh). A tap with no hit in the tile is
//     skipped. Each group's chain starts from zero and is added into the
//     float32 sum with a float32 add, in group order.
//   * The tile is written once from the accumulators.
// One launch per call; the host sizes the grid from the shapes and the
// card's occupancy, and synchronises nothing.
//
// Tried and not kept (level 0 16 -> 16 float32, chip_smoke.py's det_kernels
// phase on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6 has the
// measurements). The first version: one 64-row x TN tile per block, each
// output row's G-row window staged one 4-byte scalar at a time (read three
// times per row and group), W restaged per (tile, group), float32 FMAs on
// the CUDA cores: 0.2856 ms. Then this design, step by step: each tile's
// base rows and slots read by plain loads, W staged one element at a time in
// Wt's order, every group set up whether it hits or not: 0.1212 ms; the base
// rows and slots by cp.async a tile ahead, W read in W's order: 0.0880 ms;
// groups and taps without a hit skipped: 0.0586 ms; 16-warp blocks, out-of-
// span rows through the overflow rows instead of a branch to device memory
// in every A load, odd-width bfloat16 rows by 4-byte cp.async instead of
// 2-byte plain copies: 0.0481 ms; each group's span and tap mask found by
// one lane for all groups at once (no reductions, no walk over the groups),
// the first tile's base rows in flight while W is staged: 0.0374 ms, kept.
// `conv_phases --kernel window` splits a warp's cycles of the kept version
// into staging W ~19%, setting up tiles and spans ~37%, routing and
// multiplying ~37%.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <climits>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int MAX_NW = 16;     // warps per block, at most
constexpr int MT = 16;         // output rows per warp tile (one MMA tile)
constexpr int TN = 16;         // output columns per block (2 MMA n-tiles)
constexpr int S = 48;          // span rows staged per (tile, group)
constexpr int MAX_TAPS = 8;    // taps per group and window width taken
constexpr int MAX_GROUPS = 32; // groups: one lane each
constexpr int SMEM_MAX = 232448;   // shared memory a block can use

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int KSTEP = 8;    // m16n8k8 tf32
  static constexpr int PAD = 4;      // row strides of 4 mod 8 words
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int KSTEP = 16;   // m16n8k16 bf16
  static constexpr int PAD = 8;
};

// Byte offsets and sizes of one launch's shared memory. Per block:
// Wt[gg][TN][kstr] (T), taps[k], tpos[k] (tap t's first element in Wt),
// goff[gg + 1] (int). Per warp: span[2][S + 1][cstr] (T, row S zero),
// ovf[MT][cstr] (T, window rows read past the span), and two tiles'
// base[gg][MT] (int) and slot[k][MT] (int8).
template <typename T>
struct Layout {
  int cip, kp, kstr, cstr, span_elems;
  int wt, tapo, tposo, goffo, warp0;
  int ovfo, baseo, meta_bytes, warp_bytes;
  __host__ __device__ Layout(int ci, int gw, int gg, int k) {
    constexpr int KSTEP = Op<T>::KSTEP;
    constexpr int B = (int)sizeof(T);
    cip = (ci + KSTEP - 1) / KSTEP * KSTEP;
    kp = gw * cip;
    kstr = kp + Op<T>::PAD;
    cstr = cip + Op<T>::PAD;
    span_elems = (S + 1) * cstr;
    wt = 0;
    tapo = up16(gg * TN * kstr * B);
    tposo = tapo + k * 4;
    goffo = tposo + k * 4;
    warp0 = up16(goffo + (gg + 1) * 4);
    ovfo = up16(2 * span_elems * B);
    baseo = up16(ovfo + MT * cstr * B);
    meta_bytes = up16(gg * MT * 4 + k * MT);     // one tile's base and slots
    warp_bytes = baseo + 2 * meta_bytes;
  }
  __host__ __device__ int bytes(int nw) const { return warp0 + nw * warp_bytes; }
  __host__ __device__ static int up16(int x) { return (x + 15) / 16 * 16; }
};

// The A element of a routed row at channel c, from shared memory at element
// offset `code`: one float32, or a pair of bfloat16 in one word. ODD: rows
// of odd-width bfloat16, which may start at an odd element and run into the
// next row (masked past Ci).
template <typename T, bool ODD>
struct AWord;
template <>
struct AWord<float, false> {
  __device__ __forceinline__ static uint32_t get(const float* sp, int, int code,
                                                 int c) {
    return __float_as_uint(sp[code + c]);
  }
};
template <>
struct AWord<__nv_bfloat16, false> {
  __device__ __forceinline__ static uint32_t get(const __nv_bfloat16* sp, int,
                                                 int code, int c) {
    return *reinterpret_cast<const uint32_t*>(sp + code + c);
  }
};
template <>
struct AWord<__nv_bfloat16, true> {
  __device__ __forceinline__ static uint32_t get(const __nv_bfloat16* sp,
                                                 int ci, int code, int c) {
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    return pack_bf16(c < ci ? sp[code + c] : z,
                     c + 1 < ci ? sp[code + c + 1] : z);
  }
};

// Built with -DWINDOW_CONV_PHASES (link_tpu_torch/tools/conv_phases.py
// --kernel window), lane 0 of every warp counts the SM clock cycles it
// spends in each phase, its tiles and its (tile, group) pairs with a hit;
// `window_conv_phases` copies them out.
#ifdef WINDOW_CONV_PHASES
constexpr int NPHASE = 9;   // stage W, wait for meta, span setup, wait for a
                            // span, compute, store, total, tiles, groups
constexpr int PHASE_WARPS = 1 << 16;
__device__ long long phase_cycles[PHASE_WARPS * NPHASE];
#define PHASE_START                                  \
  long long ph_t = clock64(), ph_0 = ph_t;           \
  long long ph[NPHASE] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#define PHASE_MARK(i)                                \
  {                                                  \
    const long long now = clock64();                 \
    ph[i] += now - ph_t;                             \
    ph_t = now;                                      \
  }
#define PHASE_COUNT(i) ++ph[i];
#define PHASE_END                                                        \
  {                                                                      \
    const long long wid = ((long long)blockIdx.y * gridDim.x + blockIdx.x) \
                          * nw + warp;                                   \
    if (lane == 0 && wid < PHASE_WARPS) {                                \
      ph[6] = clock64() - ph_0;                                          \
      for (int i = 0; i < NPHASE; ++i)                                   \
        phase_cycles[wid * NPHASE + i] = ph[i];                          \
    }                                                                    \
  }
#else
#define PHASE_START
#define PHASE_MARK(i)
#define PHASE_COUNT(i)
#define PHASE_END
#endif

template <typename T, bool ODD>
__global__ void __launch_bounds__(MAX_NW * 32)
window_conv_kernel(const T* __restrict__ feats, int n, int ci,
                   const int* __restrict__ base_pos,
                   const int8_t* __restrict__ slot, int m,
                   const int* __restrict__ taps, const int* __restrict__ goff,
                   int gg, int k, int gw, const T* __restrict__ w, int co,
                   T* __restrict__ out, int vec, int meta_vec) {
  constexpr int KSTEP = Op<T>::KSTEP;
  constexpr int B = (int)sizeof(T);
  const Layout<T> L(ci, gw, gg, k);
  extern __shared__ __align__(16) unsigned char smem[];
  T* wt = reinterpret_cast<T*>(smem + L.wt);
  int* taps_s = reinterpret_cast<int*>(smem + L.tapo);
  int* goff_s = reinterpret_cast<int*>(smem + L.goffo);
  int* tpos_s = reinterpret_cast<int*>(smem + L.tposo);

  const int nt_block = blockDim.x;
  const int nw = nt_block >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;          // MMA group: rows gq and gq + 8
  const int tq = lane & 3;
  const int n0 = blockIdx.y * TN;
  unsigned char* wsm = smem + L.warp0 + warp * L.warp_bytes;
  T* span = reinterpret_cast<T*>(wsm);
  T* ovf = reinterpret_cast<T*>(wsm + L.ovfo);
  PHASE_START

  const int row_bytes = ci * B;
  const long long table_bytes = (long long)n * row_bytes;
  // pieces of one staged row: vec-byte pieces of CiP channels, or for ODD
  // the 4-byte words that cover a row and the 2 bytes before it
  const int pieces = ODD ? (row_bytes + 5) / 4 : L.cip * B / vec;
  // a span copy's lanes: rows lr, lr + rpp, ... and piece pc of each when
  // a row takes at most 32 pieces, else every lane walks every row
  const int rpp = pieces <= 32 ? 32 / pieces : 0;
  const int lr = rpp ? lane / pieces : 0;
  const int pc = rpp ? lane % pieces : lane;
  const RowCopy copy{vec};
  const int tiles = (m + MT - 1) / MT;
  const int zero_code = S * L.cstr;
  const int ovf_code = L.ovfo / B;        // ovf's element offset from span

  // A tile's base rows and slots (all groups and taps) into meta buffer
  // `mb`: 16-byte cp.async rows where M and the pointers allow (one round
  // trip, in flight while the tile before computes), else plain loads.
  auto fetch_meta = [&](int tile, int mb) {
    const int r0 = tile * MT;
    unsigned char* md = wsm + L.baseo + mb * L.meta_bytes;
    if (meta_vec) {
      for (int e = lane; e < gg * 4 + k; e += 32) {
        if (e < gg * 4)
          cp_async<16>(md + e * 16,
                       base_pos + (long long)(e >> 2) * m + r0 + (e & 3) * 4,
                       16);
        else
          cp_async<16>(md + gg * MT * 4 + (e - gg * 4) * MT,
                       slot + (long long)(e - gg * 4) * m + r0, 16);
      }
    } else {
      int* bd = reinterpret_cast<int*>(md);
      int8_t* sd = reinterpret_cast<int8_t*>(md + gg * MT * 4);
      for (int e = lane; e < gg * MT; e += 32) {
        const int r = r0 + (e % MT);
        bd[e] = r < m ? base_pos[(long long)(e / MT) * m + r] : 0;
      }
      for (int e = lane; e < k * MT; e += 32) {
        const int r = r0 + (e % MT);
        sd[e] = r < m ? slot[(long long)(e / MT) * m + r] : (int8_t)-1;
      }
    }
  };
  // Copy span rows lo .. lo + rows - 1 into buffer `buf` (rows past the
  // table, and channels from Ci to CiP, as zeros).
  auto issue = [&](int lo, int rows, int buf) {
    char* dst = reinterpret_cast<char*>(span + buf * L.span_elems);
    const char* fb = reinterpret_cast<const char*>(feats);
    const int rstep = rpp ? rpp : 1;
    for (int r = lr; r < rows; r += rstep) {
      if (rpp && lr >= rpp) break;
      const long long row = (long long)lo + r;
      const bool live = row >= 0 && row < n;
      char* d = dst + r * L.cstr * B;
      for (int p = pc; p < pieces; p += rpp ? pieces : 32) {
        if constexpr (ODD) {
          const long long a = (row * row_bytes & ~3LL) + p * 4;
          const int src = live ? (int)max(0LL, min(4LL, table_bytes - a)) : 0;
          cp_async<4>(d + p * 4, fb + (src ? a : 0), src);
        } else {
          const int off = p * vec;
          const bool read = live && off < row_bytes;
          copy.piece(d + off, fb + (read ? row * row_bytes + off : 0), read);
        }
      }
    }
  };

  // The first tile's base rows and slots are in flight while W is staged.
  const int stride = gridDim.x * nw;
  int mb = 0;
  if (blockIdx.x * nw + warp < tiles) fetch_meta(blockIdx.x * nw + warp, 0);
  cp_async_commit();

  // 1. The block's W, group-stacked and transposed (zeros first, then W's
  // elements in W's own order, 16 loads in flight per thread); the tap
  // lists; the zero rows past both span buffers.
  for (int e = tid; e < k; e += nt_block) taps_s[e] = taps[e];
  for (int e = tid; e <= gg; e += nt_block) goff_s[e] = goff[e];
  for (int e = tid * 16; e < L.tapo; e += nt_block * 16)
    *reinterpret_cast<uint4*>(smem + L.wt + e) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int gi = tid; gi < gg; gi += nt_block)
    for (int j = goff_s[gi]; j < goff_s[gi + 1]; ++j)
      tpos_s[taps_s[j]] = gi * TN * L.kstr + (j - goff_s[gi]) * L.cip;
  __syncthreads();
  {
    constexpr int U = 16;
    const int total = k * ci * TN;
    for (int e0 = tid; e0 < total; e0 += nt_block * U) {
      T v[U];
      int dst[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * nt_block;
        const int nn = e & (TN - 1);
        const int tc = e / TN;          // t * ci + c
        dst[u] = -1;
        if (e < total && n0 + nn < co) {
          v[u] = w[(long long)tc * co + n0 + nn];
          dst[u] = tpos_s[tc / ci] + nn * L.kstr + tc % ci;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (dst[u] >= 0) wt[dst[u]] = v[u];
    }
  }
  for (int e = lane; e < 2 * L.cstr; e += 32)
    span[(e / L.cstr) * L.span_elems + S * L.cstr + e % L.cstr] =
        from_f32<T>(0.f);
  __syncthreads();

  PHASE_MARK(0)
  for (int tile = blockIdx.x * nw + warp; tile < tiles; tile += stride) {
    // 2. This tile's meta has landed (and no span is in flight); the next
    // tile's is requested.
    cp_async_wait<0>();
    __syncwarp();
    PHASE_MARK(1)
    PHASE_COUNT(7)
    if (tile + stride < tiles) fetch_meta(tile + stride, mb ^ 1);
    cp_async_commit();
    const int* base_s = reinterpret_cast<const int*>(wsm + L.baseo +
                                                     mb * L.meta_bytes);
    const int8_t* slot_s = reinterpret_cast<const int8_t*>(
        wsm + L.baseo + mb * L.meta_bytes + gg * MT * 4);
    mb ^= 1;
    // slot s of tap t at tile row r, -1 for a miss (s < 0 or s >= gw; a
    // row past M holds -1)
    auto slot_at = [&](int t, int r) {
      const int s = slot_s[t * MT + r];
      return s >= gw ? -1 : s;
    };
    // Lane gi looks at group gi: which of its taps hit in the tile (each
    // tap's 16 slots are one 16-byte row, compared as unsigned bytes with
    // gw and packed to a 16-bit row mask), and its span: from the base of
    // its first row with a hit to that of its last (bases are
    // nondecreasing; were they not, the rows outside go to the overflow
    // rows), plus gw - 1, at most S rows.
    int my_lo = 0, my_rows = 0;
    unsigned my_taps = 0;
    if (lane < gg) {
      const int t0 = goff_s[lane], nt = goff_s[lane + 1] - t0;
      const unsigned g4 = (unsigned)gw * 0x01010101u;
      unsigned rowmask = 0;
      for (int j = 0; j < nt; ++j) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            slot_s + taps_s[t0 + j] * MT);
        const unsigned v[4] = {q.x, q.y, q.z, q.w};
        unsigned bits = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u)   // byte flags 0/1 -> 4 bits
          bits |= ((__vcmpltu4(v[u], g4) & 0x01010101u) * 0x00204081u) >> 21
                  << (4 * u) & (0xfu << (4 * u));
        rowmask |= bits;
        if (bits) my_taps |= 1u << j;
      }
      if (rowmask) {
        const int b0 = base_s[lane * MT + __ffs(rowmask) - 1];
        const int b1 = base_s[lane * MT + 31 - __clz(rowmask)];
        my_lo = min(b0, b1);
        my_rows = (int)min((long long)S, (long long)max(b0, b1) - my_lo + gw);
      }
    }
    unsigned active = __ballot_sync(0xffffffffu, my_rows > 0);
    auto next_active = [&]() {
      const int gi = active ? __ffs(active) - 1 : gg;
      active &= active - 1;
      return gi;
    };
    auto span_of = [&](int gi, int& lo, int& rows) {
      lo = __shfl_sync(0xffffffffu, my_lo, gi);
      rows = __shfl_sync(0xffffffffu, my_rows, gi);
    };

    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

    // the groups with a hit, in order; the next one's span in flight while
    // one multiplies
    int gi = next_active();
    int lo_next = 0, rows_next = 0;
    if (gi < gg) {
      span_of(gi, lo_next, rows_next);
      issue(lo_next, rows_next, 0);
    }
    cp_async_commit();
    for (int buf = 0; gi < gg; buf ^= 1) {
      const int lo = lo_next, rows = rows_next;
      const int gn = next_active();
      if (gn < gg) {
        span_of(gn, lo_next, rows_next);
        issue(lo_next, rows_next, buf ^ 1);
      }
      cp_async_commit();
      PHASE_MARK(2)
      PHASE_COUNT(8)
      cp_async_wait<1>();
      __syncwarp();
      PHASE_MARK(3)

      const T* sp = span + buf * L.span_elems;
      const T* wg = wt + gi * TN * L.kstr;
      const int t0 = goff_s[gi];
      unsigned taps_hit = __shfl_sync(0xffffffffu, my_taps, gi);
      float cg[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) cg[nt][q] = 0.f;
      while (taps_hit) {                // the group's taps with a hit
        const int j = __ffs(taps_hit) - 1;
        taps_hit &= taps_hit - 1;
        const int t = taps_s[t0 + j];
        // route rows gq and gq + 8 of tap j: element offsets from sp (the
        // zero row for a miss), or -row - 1 for a row outside the span
        int code[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gq + 8 * h;
          const int s = slot_at(t, r);
          const long long row = (long long)base_s[gi * MT + r] + s;
          if (s < 0 || row < 0 || row >= n) {
            code[h] = zero_code;
          } else if (row >= lo && row - lo < rows) {
            code[h] = (int)(row - lo) * L.cstr +
                      (ODD ? (int)((row * row_bytes) & 3) / 2 : 0);
          } else {
            code[h] = (int)(-row - 1);
          }
        }
        if (__any_sync(0xffffffffu, code[0] < 0 || code[1] < 0)) {
          // rows outside the span: copied into the overflow rows (zero
          // past Ci), after every lane is done with the last tap's
          __syncwarp();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (code[h] >= 0) continue;
            const int r = gq + 8 * h;
            const T* src = feats + (long long)(-code[h] - 1) * ci;
            for (int c = tq; c < L.cip; c += 4)
              ovf[r * L.cstr + c] = c < ci ? src[c] : from_f32<T>(0.f);
            code[h] = ovf_code - buf * L.span_elems + r * L.cstr;
          }
          __syncwarp();
        }
        for (int c0 = 0; c0 < L.cip; c0 += KSTEP) {
          const int kb = j * L.cip + c0;
          if constexpr (KSTEP == 8) {
            uint32_t ah[4], al[4];
            const int cc[4] = {c0 + tq, c0 + tq, c0 + tq + 4, c0 + tq + 4};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              split_tf32(__uint_as_float(AWord<T, ODD>::get(
                             sp, ci, code[q & 1], cc[q])),
                         ah[q], al[q]);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float* wr = reinterpret_cast<const float*>(wg) +
                                (nt * 8 + gq) * L.kstr + kb + tq;
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(wr[0], bh0, bl0);
              split_tf32(wr[4], bh1, bl1);
              mma_3xtf32(cg[nt], ah, al, bh0, bh1, bl0, bl1);
            }
          } else {
            const uint32_t x[4] = {
                AWord<T, ODD>::get(sp, ci, code[0], c0 + 2 * tq),
                AWord<T, ODD>::get(sp, ci, code[1], c0 + 2 * tq),
                AWord<T, ODD>::get(sp, ci, code[0], c0 + 2 * tq + 8),
                AWord<T, ODD>::get(sp, ci, code[1], c0 + 2 * tq + 8)};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const T* wr = wg + (nt * 8 + gq) * L.kstr + kb + 2 * tq;
              mma_bf16(cg[nt], x, *reinterpret_cast<const uint32_t*>(wr),
                       *reinterpret_cast<const uint32_t*>(wr + 8));
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] += cg[nt][q];
      __syncwarp();                   // the buffer is refilled next group
      PHASE_MARK(4)
      gi = gn;
    }
    // 3. The tile, written once: lane (gq, tq) holds rows gq, gq + 8 and
    // columns nt * 8 + 2 tq, + 1.
    const int r0 = tile * MT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gq + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + nt * 8 + 2 * tq;
        T* p = out + (long long)r * co + col;
        if (col < co) store(p, acc[nt][2 * h]);
        if (col + 1 < co) store(p + 1, acc[nt][2 * h + 1]);
      }
    }
    PHASE_MARK(5)
  }
  PHASE_END
}

// Warps per block: the most (up to MAX_NW) whose shared memory fits; 0 if
// not even one does.
template <typename T>
int warps_for(int ci, int gw, int gg, int k) {
  const Layout<T> L(ci, gw, gg, k);
  for (int nw = MAX_NW; nw >= 1; nw /= 2)
    if (L.bytes(nw) <= SMEM_MAX) return nw;
  return 0;
}

template <typename T, bool ODD>
int launch(const void* feats, int n, int ci, const void* base_pos,
           const void* slot, int m, const void* taps, const void* goff,
           int gg, int k, int gw, const void* w, int co, void* out,
           cudaStream_t stream) {
  static int granted = 0;
  static int sms = 0;
  static int occ_bytes = -1, occ_nw = 0, occ = 0;
  const auto kern = window_conv_kernel<T, ODD>;
  const int nw = warps_for<T>(ci, gw, gg, k);
  if (nw == 0) return (int)cudaErrorInvalidValue;
  const int bytes = Layout<T>(ci, gw, gg, k).bytes(nw);
  cudaError_t e = allow_smem(kern, bytes, granted);
  if (e != cudaSuccess) return (int)e;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (bytes != occ_bytes || nw != occ_nw) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, nw * 32,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    occ_bytes = bytes;
    occ_nw = nw;
  }
  const int vec = ODD ? 4 : copy_vec(feats, (long long)ci * sizeof(T));
  const int meta_vec = m % 16 == 0 && copy_vec(base_pos, 0) == 16 &&
                       copy_vec(slot, 0) == 16;
  const int tiles = (m + MT - 1) / MT;
  const int blocks = max(1, min((tiles + nw - 1) / nw, sms * max(occ, 1)));
  const dim3 grid(blocks, (co + TN - 1) / TN);
  kern<<<grid, nw * 32, bytes, stream>>>(
      (const T*)feats, n, ci, (const int*)base_pos, (const int8_t*)slot, m,
      (const int*)taps, (const int*)goff, gg, k, gw, (const T*)w, co,
      (T*)out, vec, meta_vec);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef WINDOW_CONV_PHASES
// The phase counts of the first `warps` warps since the last call, NPHASE
// each, copied to host memory `dst` (then zeroed).
extern "C" int window_conv_phases(void* dst, int warps) {
  const size_t bytes = sizeof(long long) * NPHASE * min(warps, PHASE_WARPS);
  cudaError_t e = cudaMemcpyFromSymbol(dst, phase_cycles, bytes);
  if (e != cudaSuccess) return (int)e;
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, phase_cycles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(long long) * NPHASE * PHASE_WARPS);
}
#endif

// dtype: 0 = float32, 1 = bfloat16. `gw` is the window width (the largest
// group, at most MAX_TAPS taps), `n_groups` at most MAX_GROUPS, `k` the
// number of taps (slot's rows). All pointers are device pointers;
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for shapes it does not take (a
// window or group count past the limits, or W and one warp's buffers past
// the card's 232,448 bytes of shared memory a block).
extern "C" int window_conv(const void* feats, int n, int ci,
                           const void* base_pos, const void* slot, int m,
                           const void* taps, const void* goff, int n_groups,
                           int k, int gw, const void* w, int co, void* out,
                           int dtype, void* stream) {
  if (gw < 1 || gw > MAX_TAPS || n < 1 || ci < 1 || k < 1 || n_groups < 1 ||
      n_groups > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || co <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, false>(feats, n, ci, base_pos, slot, m, taps, goff,
                                n_groups, k, gw, w, co, out, s);
  if (dtype == 1) {
    if (copy_vec(feats, (long long)ci * 2) == 2)
      return launch<__nv_bfloat16, true>(feats, n, ci, base_pos, slot, m,
                                         taps, goff, n_groups, k, gw, w, co,
                                         out, s);
    return launch<__nv_bfloat16, false>(feats, n, ci, base_pos, slot, m,
                                        taps, goff, n_groups, k, gw, w, co,
                                        out, s);
  }
  return (int)cudaErrorInvalidValue;
}
