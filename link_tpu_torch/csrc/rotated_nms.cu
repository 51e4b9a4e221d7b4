// rotated_nms: rotated BEV non-maximum suppression over S fixed-size
// candidate sets at once, on the card.
//
// It replaces link_tpu/ops/nms.py:171 `rotate_nms_jax`, which runs in XLA
// (no Pallas counterpart): per set, boxes (N, 5) float32 [x y w l r],
// scores (N,) float32 and valid (N,) bool in; a keep mask (N,) bool in
// INPUT order out, at most max_keep kept, with priority by descending score
// and ties by the lower index (JAX's stable argsort, with -0 equal to 0 and
// NaN last). The sets are independent and share N, thresh and max_keep:
// det serving stacks every task of a frame into one call. The plain twin is
// link_tpu_torch/ops/nms.py `rotate_nms_device`.
//
// Three launches, each over all S sets (blockIdx.y or blockIdx.x = set):
//
//   nms_rank_kernel  ranks and boxes. Each block stages the set's sort keys
//                    in shared memory; 32 rows per block, one a lane, and
//                    8 warps each count an eighth of the columns that come
//                    first in score order (a counting sort on a total-order
//                    key: no library sort). Each valid row then builds its
//                    box once (corners, centre, area, circumscribed radius,
//                    in double) into a scratch array AT ITS RANK, and its
//                    input index into `order`; block 0 writes the set's
//                    valid count.
//   nms_mask_kernel  the pair mask in rank order, upper triangle only: one
//                    block of 4 warps per (64-rank row tile <= 64-rank
//                    column tile) within the valid count. Bit (r, c), c > r,
//                    says that rank r's box overlaps rank c's, with rank r,
//                    the earlier one, as the clip's subject. The block
//                    stages both tiles' boxes in shared memory; all lanes
//                    run the circle test on the tile's pairs (uniform work:
//                    squared distances, the exact hypot only within 1e-6 of
//                    the boundary), and each warp compacts the pairs that
//                    pass into its own shared-memory queue (__ballot_sync,
//                    __popc); the warp then clips its queued pairs one pair
//                    per lane, so no lane waits on another's clip. Each
//                    lane's polygon lives in a buffer of its own in shared
//                    memory, the warp's lanes interleaved (vertex k of a
//                    lane at buf[k * 32], no bank conflicts): a convex quad
//                    clipped by a convex quad has at most 8 vertices, so
//                    each stage runs unrolled over 8 slots. A buffer in
//                    registers was tried and lost: a clip writes its output
//                    vertex at a data-dependent slot, which registers take
//                    only through a select per slot (PERF.md §6). A
//                    stage whose rounding would need more vertices than 8
//                    (possible only for vertices within ~1e-15 of a clip
//                    line) flags the pair, and its lane redoes it alone in
//                    a larger scratch of the warp (clip_area_slow), so the
//                    result is the reference clip's for every input. No
//                    input of the tests or of chip_smoke.py reaches that
//                    redo by itself; a build with -DROTATED_NMS_CLIP_REDO
//                    (a library of its own, `kernels.rotated_nms_clip_redo`)
//                    sends every clipped pair through it, and chip_smoke.py
//                    holds that build's keep masks against this one's.
//   nms_walk_kernel  one warp per set: the greedy walk in rank order, 64
//                    ranks (one mask word) at a time. The warp copies the
//                    next chunk's rows of the mask into shared memory
//                    (cp.async, two buffers) while it resolves this one: it
//                    walks the chunk serially on its diagonal word (keep
//                    rank r unless removed, then OR in its bits), jumping
//                    from one live rank to the next with __ffsll, then ORs
//                    the kept rows' words of the later chunks into
//                    `removed`. The walk stops at max_keep keeps, which
//                    equals JAX's cap after its full sweep (a row past the
//                    cap only suppresses rows after it). The keep mask is
//                    written in input order through `order`.
//
// The IoU is the Sutherland-Hodgman clip of link_tpu_torch/native/nms.cpp
// in double precision, with its circumscribed-circle reject: the kept set
// equals the host native NMS up to double rounding (~1e-15 in the IoU). The
// twin's formulation (the 24-candidate hull in float32) differs from it by
// float32 rounding, so a pair whose IoU lies that close to thresh may be
// decided differently; `rotated_nms_iou` writes this kernel's IoU matrix
// (the same tile code in input order, every pair) so that a check can
// count such pairs.
//
// What bounds it: at S = 6, N = 1,000 (nms_pre_max_size, six tasks) the
// inputs are ~150 KB and the pair work is ~3 M circle tests and a clip for
// the ~1.6% that pass, well under a microsecond at the card's float rate;
// the least time is three launches' latency. What remains is latency: the
// launches, the mask tiles' chains of dependent float64 work (the circle
// tests, then a clip of ~4 x 7 divisions per lane), and the walk's chain
// of chunks (a shared-memory read per kept rank). PERF.md §6 gives the
// time of each launch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry points, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "mma_sm90.cuh"   // cp.async

namespace {

using namespace mma_sm90;

constexpr int TILE = 64;              // ranks per mask tile side: one word
constexpr int MAX_N = 8192;           // candidates per set one call takes
constexpr int RANK_ROWS = 32;         // rows per block of nms_rank_kernel
constexpr int RANK_THREADS = 256;     // its warps split the columns
constexpr int MASK_THREADS = 128;     // threads of one mask tile
constexpr int MASK_WARPS = MASK_THREADS / 32;
constexpr int PLANES = 12;            // doubles of one box in the scratch
constexpr int POLY = 8;               // vertices of a lane's polygon buffer
constexpr int SLOW_VERTS = 64;        // a clip stage at most doubles them
static_assert(2 * SLOW_VERTS <= POLY * 32, "the slow clip's scratch");
constexpr unsigned FULL = 0xffffffffu;

struct P2 {
  double x, y;
};

// native/nms.cpp box_corners for a [x y w l r] row: R(-r), as the det3d
// rotation_2d convention. Planes: cx cy area rad, then the corners x0 y0 ..
// x3 y3, counter-clockwise.
__device__ __forceinline__ void make_box(const float* b, double* o) {
  const double cx = b[0], cy = b[1];
  const double hw = b[2] * 0.5, hl = b[3] * 0.5;
  const double cs = cos((double)b[4]), sn = sin((double)b[4]);
  const double dx[4] = {-hw, hw, hw, -hw};
  const double dy[4] = {-hl, -hl, hl, hl};
  o[0] = cx;
  o[1] = cy;
  o[2] = (double)b[2] * b[3];
  o[3] = 0.5 * hypot((double)b[2], (double)b[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[4 + 2 * i] = cx + dx[i] * cs + dy[i] * sn;
    o[5 + 2 * i] = cy - dx[i] * sn + dy[i] * cs;
  }
}

// The clip's polygon lives in a buffer of the lane's own in shared memory:
// POLY vertices (a convex quad clipped by a convex quad has at most 8), the
// warp's lanes interleaved (vertex k of a lane at buf[k * 32]) so that the
// lanes' accesses never conflict in a bank whichever vertex each touches.
// A write lands at a position that depends on the lane's data, which a
// buffer in registers can only take through a select per slot.

// one Sutherland-Hodgman stage of native/nms.cpp clip_polygon on a lane's
// buffer: its CIN inputs read into registers first, the outputs (at most
// CIN + 1) written back in place; `over` is set when the stage would have
// produced more
template <int CIN>
__device__ __forceinline__ int clip_stage(P2* buf, int n, P2 a, P2 b,
                                          bool& over) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  P2 in[CIN];
#pragma unroll
  for (int i = 0; i < CIN; ++i) in[i] = buf[i * 32];
  const P2 last = buf[(n > 0 ? n - 1 : 0) * 32];
  int m = 0;
#pragma unroll
  for (int i = 0; i < CIN; ++i) {
    const P2 cur = in[i];
    const P2 prev = i == 0 ? last : in[i > 0 ? i - 1 : 0];
    const double dc = ex * (cur.y - a.y) - ey * (cur.x - a.x);
    const double dp = ex * (prev.y - a.y) - ey * (prev.x - a.x);
    const bool ic = dc >= -1e-12, ip = dp >= -1e-12;
    if (i < n) {
      if (ic != ip) {
        const double t = dp / (dp - dc);
        P2 v;
        v.x = prev.x + t * (cur.x - prev.x);
        v.y = prev.y + t * (cur.y - prev.y);
        if (m <= CIN) buf[m * 32] = v;
        ++m;
      }
      if (ic) {
        if (m <= CIN) buf[m * 32] = cur;
        ++m;
      }
    }
  }
  over |= m > CIN + 1;
  return m;
}

// native/nms.cpp clip_polygon + polygon_area: the area of the subject quad
// (corners x0 y0 .. x3 y3) clipped by the clip quad, both counter-
// clockwise, in the lane's buffer; `over` as clip_stage
__device__ __forceinline__ double clip_area(const double* subj,
                                            const double* clip, P2* buf,
                                            bool& over) {
  P2 c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    buf[i * 32].x = subj[2 * i];
    buf[i * 32].y = subj[2 * i + 1];
    c[i].x = clip[2 * i];
    c[i].y = clip[2 * i + 1];
  }
  int n = clip_stage<4>(buf, 4, c[0], c[1], over);
  n = clip_stage<5>(buf, n, c[1], c[2], over);
  n = clip_stage<6>(buf, n, c[2], c[3], over);
  n = clip_stage<7>(buf, n, c[3], c[0], over);
  if (n < 3) return 0.0;
  double s = 0;
  for (int i = 0; i < n; ++i) {
    const P2 p = buf[i * 32];
    const P2 q = buf[((i + 1) % n) * 32];
    s += p.x * q.y - q.x * p.y;
  }
  return fabs(s) * 0.5;
}

// the same clip with its polygons in a scratch of 2 x SLOW_VERTS vertices,
// for a pair that clip_area flagged (each stage at most doubles the vertex
// count: 4, 8, 16, 32, 64)
__device__ double clip_area_slow(const double* subj, const double* clip,
                                 P2* scratch) {
  P2* in = scratch;
  P2* ot = scratch + SLOW_VERTS;
  int n = 4;
  for (int i = 0; i < 4; ++i) {
    in[i].x = subj[2 * i];
    in[i].y = subj[2 * i + 1];
  }
  for (int e = 0; e < 4 && n > 0; ++e) {
    P2 a, b;
    a.x = clip[2 * e];
    a.y = clip[2 * e + 1];
    b.x = clip[2 * ((e + 1) & 3)];
    b.y = clip[2 * ((e + 1) & 3) + 1];
    const double ex = b.x - a.x, ey = b.y - a.y;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const P2 cur = in[i];
      const P2 prev = in[(i + n - 1) % n];
      const double dc = ex * (cur.y - a.y) - ey * (cur.x - a.x);
      const double dp = ex * (prev.y - a.y) - ey * (prev.x - a.x);
      const bool ic = dc >= -1e-12, ip = dp >= -1e-12;
      if (ic != ip) {
        const double t = dp / (dp - dc);
        ot[m].x = prev.x + t * (cur.x - prev.x);
        ot[m].y = prev.y + t * (cur.y - prev.y);
        ++m;
      }
      if (ic) ot[m++] = cur;
    }
    n = m;
    P2* sw = in;
    in = ot;
    ot = sw;
  }
  if (n < 3) return 0.0;
  double s = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    s += in[i].x * in[j].y - in[j].x * in[i].y;
  }
  return fabs(s) * 0.5;
}

// ascending order of the key = descending score; -0 as +0 and every NaN as
// +NaN (last), as JAX canonicalizes floats before it sorts. Every key is at
// most 0x7fc00000, so INT_MAX marks an invalid row.
__device__ int sort_key(float score) {
  float f = -score;
  if (f == 0.0f) f = 0.0f;
  int b = isnan(f) ? 0x7fc00000 : __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The scratch of one call, carved from one buffer (see scratch_bytes):
// the mask (S, N, words) words, the boxes (S, PLANES, N) doubles in rank
// order, order (S, N) int32 (the input index of each rank) and nv (S,).
struct Scratch {
  unsigned long long* mask;
  double* box;
  int* order;
  int* nv;
};

size_t scratch_bytes(int s, int n) {
  const size_t words = (n + TILE - 1) / TILE;
  return (size_t)s * n * (words * 8 + PLANES * 8 + 4) + (size_t)s * 4;
}

Scratch carve(void* p, int s, int n) {
  const size_t words = (n + TILE - 1) / TILE;
  char* c = (char*)p;
  Scratch o;
  o.mask = (unsigned long long*)c;
  c += (size_t)s * n * words * 8;
  o.box = (double*)c;
  c += (size_t)s * PLANES * n * 8;
  o.order = (int*)c;
  c += (size_t)s * n * 4;
  o.nv = (int*)c;
  return o;
}

__global__ void __launch_bounds__(RANK_THREADS)
nms_rank_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int n, Scratch sc) {
  __shared__ int key[MAX_N];
  __shared__ int part[RANK_THREADS / 32][32];
  __shared__ int s_nv;
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const size_t base = (size_t)s * n;
  if (t == 0) s_nv = 0;
  __syncthreads();
  int mine = 0;
#pragma unroll 4
  for (int j = t; j < n; j += RANK_THREADS) {
    const bool v = valid[base + j];
    key[j] = v ? sort_key(scores[base + j]) : INT_MAX;
    mine += v;
  }
  if (mine) atomicAdd(&s_nv, mine);
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  const int i = blockIdx.x * RANK_ROWS + lane;
  const int ki = i < n ? key[i] : INT_MAX;
  const int span = (n + RANK_THREADS / 32 - 1) / (RANK_THREADS / 32);
  const int j1 = min(n, (warp + 1) * span);
  int before = 0;
  for (int j = warp * span; j < j1; ++j) {
    const int kj = key[j];
    before += kj < ki || (kj == ki && j < i);
  }
  part[warp][lane] = before;
  __syncthreads();
  if (blockIdx.x == 0 && t == 0) sc.nv[s] = s_nv;
  if (warp != 0 || ki == INT_MAX) return;
  int rank = 0;
#pragma unroll
  for (int w = 0; w < RANK_THREADS / 32; ++w) rank += part[w][lane];
  sc.order[base + rank] = i;
  double o[PLANES];
  make_box(boxes + (base + i) * 5, o);
  double* dst = sc.box + (size_t)s * PLANES * n + rank;
#pragma unroll
  for (int k = 0; k < PLANES; ++k) dst[(size_t)k * n] = o[k];
}

// Whether two boxes' circumscribed circles meet (the reference's reject:
// hypot(dx, dy) <= ra + rb). The squares decide a pair that is not within
// 1e-6 of the boundary, far beyond their rounding, so that only those few
// take the exact hypot.
__device__ __forceinline__ bool circles_meet(double dx, double dy,
                                             double rs) {
  const double d2 = dx * dx + dy * dy, r2 = rs * rs;
  if (d2 > r2 * (1.0 + 1e-6)) return false;
  if (d2 < r2 * (1.0 - 1e-6)) return true;
  return !(hypot(dx, dy) > rs);
}

// The pairs of one (row tile, column tile): IOU false, the mask tile of
// rotated_nms (rank order, c > r, within the valid count nv), each row's
// bits written as its word `word`; IOU true, every pair's IoU into out
// (n, n), input order (rotated_nms_iou).
template <bool IOU>
__device__ __forceinline__ void pair_tile(
    const double* __restrict__ box, const float* __restrict__ raw, int n,
    int nv, int r0, int c0, float thresh, unsigned long long* mask_rows,
    int words, int word, double* __restrict__ out) {
  constexpr int PER_WARP = TILE * TILE / MASK_WARPS;
  __shared__ double s_ctr[2][3][TILE];          // cx, cy, rad
  __shared__ double s_area[2][TILE];
  __shared__ double s_q[2][TILE][8];             // corners
  __shared__ unsigned short queue[MASK_WARPS][PER_WARP];
  __shared__ unsigned long long bits[TILE];
  __shared__ P2 poly[MASK_WARPS][POLY * 32];      // the lanes' polygons
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  {
    const int side = t / TILE, k = t % TILE;     // 0 rows, 1 columns
    const int idx = (side ? c0 : r0) + k;
    if (idx < nv) {
      double o[PLANES];
      if (IOU) {
        make_box(raw + (size_t)idx * 5, o);
      } else {
#pragma unroll
        for (int p = 0; p < PLANES; ++p) o[p] = box[(size_t)p * n + idx];
      }
      s_ctr[side][0][k] = o[0];
      s_ctr[side][1][k] = o[1];
      s_area[side][k] = o[2];
      s_ctr[side][2][k] = o[3];
#pragma unroll
      for (int p = 0; p < 8; ++p) s_q[side][k][p] = o[4 + p];
    }
    if (t < TILE) bits[t] = 0;
  }
  __syncthreads();

  // the circle test on every pair of the tile; each warp queues the pairs
  // that pass of its own share, in its own queue (no atomics)
  int nq = 0;
#pragma unroll 4
  for (int it = 0; it < PER_WARP / 32; ++it) {
    const int p = it * MASK_THREADS + t;
    const int r = p / TILE, c = p % TILE;
    const int R = r0 + r, C = c0 + c;
    bool pass = false;
    if (R < nv && C < nv && (IOU || C > R)) {
      pass = circles_meet(s_ctr[1][0][c] - s_ctr[0][0][r],
                          s_ctr[1][1][c] - s_ctr[0][1][r],
                          s_ctr[0][2][r] + s_ctr[1][2][c]);
      if (IOU && !pass) out[(size_t)R * n + C] = 0.0;
    }
    const unsigned ballot = __ballot_sync(FULL, pass);
    if (pass)
      queue[warp][nq + __popc(ballot & ((1u << lane) - 1))] =
          (unsigned short)p;
    nq += __popc(ballot);
  }
  __syncwarp();

  // the warp's queued pairs, one pair per lane
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int q = q0 + lane;
    const bool has = q < nq;
    int r = 0, c = 0;
    if (has) {
      const int p = queue[warp][q];
      r = p / TILE;
      c = p % TILE;
    }
    bool over = false;
    double inter = 0.0;
    if (has)
      inter = clip_area(s_q[0][r], s_q[1][c], poly[warp] + lane, over);
    // a flagged pair is redone by its lane alone, in the whole warp's
    // buffer (every lane has its area by now); the redo build redoes every
    // pair
#ifdef ROTATED_NMS_CLIP_REDO
    unsigned hard = __ballot_sync(FULL, has);
#else
    unsigned hard = __ballot_sync(FULL, has && over);
#endif
    while (hard) {
      if (lane == __ffs(hard) - 1)
        inter = clip_area_slow(s_q[0][r], s_q[1][c], poly[warp]);
      hard &= hard - 1;
      __syncwarp();
    }
    if (has) {
      const double uni = s_area[0][r] + s_area[1][c] - inter;
      const double iou = uni > 0 ? inter / uni : 0.0;
      if (IOU)
        out[(size_t)(r0 + r) * n + c0 + c] = iou;
      else if (iou > (double)thresh)
        atomicOr(&bits[r], 1ull << c);
    }
  }
  if (IOU) return;
  __syncthreads();
  if (t < TILE && r0 + t < nv)
    mask_rows[(size_t)(r0 + t) * words + word] = bits[t];
}

__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(int n, float thresh, Scratch sc) {
  const int s = blockIdx.y;
  const int nv = sc.nv[s];
  // blockIdx.x enumerates the tiles (rt <= ct) column by column
  const int k = blockIdx.x;
  int ct = (int)((sqrt(8.0 * k + 1.0) - 1.0) * 0.5);
  while ((ct + 1) * (ct + 2) / 2 <= k) ++ct;
  while (ct * (ct + 1) / 2 > k) --ct;
  const int rt = k - ct * (ct + 1) / 2;
  if (ct * TILE >= nv) return;
  const int words = (n + TILE - 1) / TILE;
  pair_tile<false>(sc.box + (size_t)s * PLANES * n, nullptr, n, nv,
                   rt * TILE, ct * TILE, thresh,
                   sc.mask + (size_t)s * n * words, words, ct, nullptr);
}

__global__ void __launch_bounds__(MASK_THREADS)
nms_iou_kernel(const float* __restrict__ boxes, int n,
               double* __restrict__ out) {
  pair_tile<true>(nullptr, boxes, n, n, blockIdx.y * TILE,
                  blockIdx.x * TILE, 0.f, nullptr, 0, 0, out);
}

// The walk's shared memory: removed and kept bits (words each), two chunks
// of the mask, and the order (n).
size_t walk_smem(int n) {
  const size_t words = (n + TILE - 1) / TILE;
  return (2 + 2 * TILE) * words * 8 + (size_t)n * 4;
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(int n, int max_keep, Scratch sc, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int words = (n + TILE - 1) / TILE;
  unsigned long long* removed = smem;              // (words,)
  unsigned long long* kept_bits = smem + words;    // (words,)
  unsigned long long* tiles = smem + 2 * words;    // 2 x (TILE, words)
  int* order = (int*)(tiles + 2 * TILE * words);   // (n,)
  const int nv = sc.nv[s];
  const int wv = (nv + TILE - 1) / TILE;
  const unsigned long long* mask = sc.mask + (size_t)s * n * words;
  uint8_t* out = keep + (size_t)s * n;
  // chunk c's rows of the mask, whole (contiguous: coalesced), into buffer
  // c & 1 (cp.async); the walk reads words c .. wv - 1 of them
  auto load = [&](int c) {
    const int count = min(TILE, nv - c * TILE) * words;
    unsigned long long* dst = tiles + (size_t)(c & 1) * TILE * words;
    const unsigned long long* src = mask + (size_t)c * TILE * words;
    for (int e = lane; e < count; e += 32) cp_async<8>(dst + e, src + e, 8);
    cp_async_commit();
  };
  for (int i = lane; i < n; i += 32) out[i] = 0;
  for (int w = lane; w < wv; w += 32) removed[w] = kept_bits[w] = 0;
  // `order` rides with chunk 0, for the keep written at the end
  for (int r = lane; r < nv; r += 32)
    cp_async<4>(order + r, sc.order + (size_t)s * n + r, 4);
  if (wv > 0) load(0);
  int kept = 0;
  for (int c = 0; c < wv && kept < max_keep; ++c) {
    cp_async_wait<0>();
    __syncwarp();             // chunk c landed; `removed` final
    if (c + 1 < wv) load(c + 1);           // in flight during this chunk
    const unsigned long long* tile = tiles + (size_t)(c & 1) * TILE * words;
    const int rows = min(TILE, nv - c * TILE);
    // the chunk's own ranks, in order, on its diagonal word: every lane
    // runs the same serial loop on the same values
    const unsigned long long live = rows == TILE ? ~0ull : (1ull << rows) - 1;
    unsigned long long rem = removed[c];
    unsigned long long avail = ~rem & live;
    unsigned long long kb = 0;
    while (avail && kept < max_keep) {
      const int b = __ffsll((long long)avail) - 1;
      kb |= 1ull << b;
      ++kept;
      rem |= tile[b * words + c];
      avail = ~rem & live & (b == TILE - 1 ? 0ull : ~0ull << (b + 1));
    }
    if (lane == 0) kept_bits[c] = kb;
    // the kept rows' words of the later chunks
    for (int w = c + 1 + lane; w < wv; w += 32) {
      unsigned long long acc = 0;
      for (unsigned long long m = kb; m; m &= m - 1)
        acc |= tile[(__ffsll((long long)m) - 1) * words + w];
      removed[w] |= acc;
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  // the keep in input order, once, after the walk (no global read on it)
  for (int r = lane; r < nv; r += 32)
    if ((kept_bits[r / TILE] >> (r % TILE)) & 1ull) out[order[r]] = 1;
}

}  // namespace

// boxes (s, n, 5) float32, scores (s, n) float32, valid (s, n) bool; a
// scratch of scratch_bytes(s, n) bytes (ops/kernels.py _nms_scratch_bytes);
// keep (s, n) bool out. n in [1, 8192]. Three launches: ranks and boxes,
// the mask, the walk.
extern "C" int rotated_nms(const void* boxes, const void* scores,
                           const void* valid, int s, int n, float thresh,
                           int max_keep, void* scratch,
                           long long scratch_size, void* keep, void* stream) {
  if (n <= 0 || n > MAX_N || s <= 0 ||
      scratch_size < (long long)scratch_bytes(s, n))
    return (int)cudaErrorInvalidValue;
  const Scratch sc = carve(scratch, s, n);
  const int words = (n + TILE - 1) / TILE;
  cudaStream_t st = (cudaStream_t)stream;
  nms_rank_kernel<<<dim3((n + RANK_ROWS - 1) / RANK_ROWS, s), RANK_THREADS,
                    0, st>>>((const float*)boxes, (const float*)scores,
                             (const uint8_t*)valid, n, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, s), MASK_THREADS, 0, st>>>(
      n, thresh, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = walk_smem(n);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_walk_kernel<<<s, 32, smem, st>>>(n, max_keep, sc, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

// The IoU matrix (n, n) float64 that `rotated_nms` thresholds, by the same
// tile code (row i the subject, column j the clip quad), in input order.
extern "C" int rotated_nms_iou(const void* boxes, int n, void* out,
                               void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int words = (n + TILE - 1) / TILE;
  nms_iou_kernel<<<dim3(words, words), MASK_THREADS, 0,
                   (cudaStream_t)stream>>>((const float*)boxes, n,
                                           (double*)out);
  return (int)cudaGetLastError();
}
