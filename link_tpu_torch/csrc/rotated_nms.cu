// rotated_nms: rotated BEV non-maximum suppression over a fixed-size
// candidate set, on the card.
//
// It replaces link_tpu/ops/nms.py:171 `rotate_nms_jax`, which runs in XLA
// (no Pallas counterpart): boxes (N, 5) float32 [x y w l r], scores (N,)
// float32 and valid (N,) bool in; a keep mask (N,) bool in INPUT order out,
// at most max_keep kept, with priority by descending score and ties by the
// lower index (JAX's stable argsort, with -0 equal to 0 and NaN last). The
// plain twin is link_tpu_torch/ops/nms.py `rotate_nms_device`.
//
// Two launches, after the reference's iou3d_nms_kernel.cu (nms_gpu):
//
//   nms_mask_kernel   one block of 64 threads per (64-row tile, 64-column
//                     tile) of the N x N pairs, in input order. The block
//                     stages its 64 column boxes (corners, area, radius,
//                     sort key) in shared memory; thread i writes one 64-bit
//                     word whose bit k says that row i overlaps column
//                     j0 + k (IoU > thresh, both valid, j != i), and the
//                     count of valid columns of the tile that come before it
//                     in score order (its partial rank).
//   nms_sweep_kernel  one block. Its threads add up each valid row's partial
//                     ranks and place the row at its rank (a stable counting
//                     sort: no library sort and no scatter back); then one
//                     warp walks the valid rows in score order, keeps a row
//                     that no kept row has removed, ORs its mask row into the
//                     removed bits (shared memory, one word a lane), and
//                     stops after max_keep keeps. The keep mask is written
//                     in input order.
//
// The mask holds every ordered pair, not only the upper triangle of a
// sorted order: the bit (i, j) is read only when i comes first, so the rows
// need not be sorted before the pairs are computed. Capping the keeps in the
// walk equals JAX's cap after its full sweep, since a row past the cap only
// suppresses rows after it.
//
// The IoU is the Sutherland-Hodgman clip of link_tpu_torch/native/nms.cpp
// in double precision, with its circumscribed-circle reject: the kept set
// equals the host native NMS up to double rounding (~1e-15 in the IoU). The
// twin's formulation (the 24-candidate hull in float32) differs from it by
// float32 rounding, so a pair whose IoU lies that close to thresh may be
// decided differently; `rotated_nms_iou` writes this kernel's IoU matrix so
// that a check can count such pairs.
//
// What bounds it: at N = 1,000 (nms_pre_max_size) the inputs are 24 KB and
// the pair work is ~0.5 M circle tests and a clip for the pairs that pass,
// a fraction of a microsecond at the card's float rate. Neither bytes nor
// operations set its time: the clips run per thread with their polygons in
// local memory, the walk is serial over the valid rows (a shared-memory
// read per row, a 16-word load per kept row), and each launch costs a few
// microseconds. PERF.md §6 gives its time, and its pair work's share
// (timed through `rotated_nms_iou`).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry points, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 64;              // rows and columns of a mask tile
constexpr int MAX_N = 8192;           // candidates one call takes
constexpr int MAX_WORDS = MAX_N / TILE;
constexpr int SWEEP_THREADS = 1024;

struct P2 {
  double x, y;
};

struct Box {
  P2 c[4];                  // corners, counter-clockwise
  double cx, cy, area, rad;
};

// native/nms.cpp box_corners for a [x y w l r] row: R(-r), as the det3d
// rotation_2d convention
__device__ void make_box(const float* b, Box& o) {
  o.cx = b[0];
  o.cy = b[1];
  const double hw = b[2] * 0.5, hl = b[3] * 0.5;
  const double cs = cos((double)b[4]), sn = sin((double)b[4]);
  const double dx[4] = {-hw, hw, hw, -hw};
  const double dy[4] = {-hl, -hl, hl, hl};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.c[i].x = o.cx + dx[i] * cs + dy[i] * sn;
    o.c[i].y = o.cy - dx[i] * sn + dy[i] * cs;
  }
  o.area = (double)b[2] * b[3];
  o.rad = 0.5 * hypot((double)b[2], (double)b[3]);
}

// native/nms.cpp clip_polygon + polygon_area: the area of the subject quad
// clipped by the convex clip quad (both counter-clockwise)
__device__ double clip_area(const P2* subj, const P2* clip) {
  P2 buf1[16], buf2[16];
  int n = 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) buf1[i] = subj[i];
  P2* in = buf1;
  P2* ot = buf2;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const P2 a = clip[e];
    const P2 b = clip[(e + 1) & 3];
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

// IoU of a (the subject: the row, kept first) and b; 0 when the
// circumscribed circles are apart or the union is not positive
__device__ double pair_iou(const Box& a, const Box& b) {
  const double d = hypot(b.cx - a.cx, b.cy - a.cy);
  if (d > a.rad + b.rad) return 0.0;
  const double inter = clip_area(a.c, b.c);
  const double uni = a.area + b.area - inter;
  return uni > 0 ? inter / uni : 0.0;
}

// ascending order of the key = descending score; -0 as +0 and every NaN as
// +NaN (last), as JAX canonicalizes floats before it sorts
__device__ int sort_key(float score) {
  float f = -score;
  if (f == 0.0f) f = 0.0f;
  int b = isnan(f) ? 0x7fc00000 : __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__global__ void __launch_bounds__(TILE)
nms_mask_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int n, float thresh,
                int words, unsigned long long* __restrict__ mask,
                int* __restrict__ partial) {
  __shared__ Box cb[TILE];
  __shared__ int ck[TILE];
  __shared__ uint8_t cv[TILE];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * TILE;
  const int j = j0 + t;
  cv[t] = j < n ? valid[j] : 0;
  if (j < n) {
    make_box(boxes + (size_t)j * 5, cb[t]);
    ck[t] = sort_key(scores[j]);
  }
  __syncthreads();
  const int i = blockIdx.y * TILE + t;
  if (i >= n) return;
  unsigned long long bits = 0;
  int before = 0;
  if (valid[i]) {
    Box a;
    make_box(boxes + (size_t)i * 5, a);
    const int ki = sort_key(scores[i]);
    const int cols = min(TILE, n - j0);
    for (int k = 0; k < cols; ++k) {
      if (!cv[k]) continue;
      const int jj = j0 + k;
      before += ck[k] < ki || (ck[k] == ki && jj < i);
      if (jj != i && pair_iou(a, cb[k]) > (double)thresh) bits |= 1ull << k;
    }
  }
  mask[(size_t)i * words + blockIdx.x] = bits;
  partial[(size_t)blockIdx.x * n + i] = before;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const uint8_t* __restrict__ valid, int n, int words,
                 const unsigned long long* __restrict__ mask,
                 const int* __restrict__ partial, int max_keep,
                 uint8_t* __restrict__ keep) {
  __shared__ int order[MAX_N];
  __shared__ unsigned long long removed[MAX_WORDS];
  __shared__ int n_valid;
  const int t = threadIdx.x;
  if (t == 0) n_valid = 0;
  for (int w = t; w < words; w += SWEEP_THREADS) removed[w] = 0;
  __syncthreads();
  int mine = 0;
  for (int i = t; i < n; i += SWEEP_THREADS) {
    keep[i] = 0;
    if (!valid[i]) continue;
    int rank = 0;
    for (int c = 0; c < words; ++c) rank += partial[(size_t)c * n + i];
    order[rank] = i;
    ++mine;
  }
  if (mine) atomicAdd(&n_valid, mine);
  __syncthreads();
  if (t >= 32) return;
  const int nv = n_valid;
  int kept = 0;
  for (int r = 0; r < nv && kept < max_keep; ++r) {
    const int i = order[r];
    if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
    if (t == 0) keep[i] = 1;
    ++kept;
    for (int w = t; w < words; w += 32)
      removed[w] |= mask[(size_t)i * words + w];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(TILE)
nms_iou_kernel(const float* __restrict__ boxes, int n,
               double* __restrict__ out) {
  __shared__ Box cb[TILE];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * TILE;
  if (j0 + t < n) make_box(boxes + (size_t)(j0 + t) * 5, cb[t]);
  __syncthreads();
  const int i = blockIdx.y * TILE + t;
  if (i >= n) return;
  Box a;
  make_box(boxes + (size_t)i * 5, a);
  const int cols = min(TILE, n - j0);
  for (int k = 0; k < cols; ++k)
    out[(size_t)i * n + j0 + k] = pair_iou(a, cb[k]);
}

}  // namespace

// boxes (n, 5) float32, scores (n,) float32, valid (n,) bool; scratch mask
// (n * words) uint64 and partial (words * n) int32, words = ceil(n / 64);
// keep (n,) bool out. n in [1, 8192].
extern "C" int rotated_nms(const void* boxes, const void* scores,
                           const void* valid, int n, float thresh,
                           int max_keep, void* mask, void* partial,
                           void* keep, void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int words = (n + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(words, words), TILE, 0, s>>>(
      (const float*)boxes, (const float*)scores, (const uint8_t*)valid, n,
      thresh, words, (unsigned long long*)mask, (int*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<1, SWEEP_THREADS, 0, s>>>(
      (const uint8_t*)valid, n, words, (const unsigned long long*)mask,
      (const int*)partial, max_keep, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

// The IoU matrix (n, n) float64 that `rotated_nms` thresholds, by the same
// device function (row i the subject, column j the clip quad).
extern "C" int rotated_nms_iou(const void* boxes, int n, void* out,
                               void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int words = (n + TILE - 1) / TILE;
  nms_iou_kernel<<<dim3(words, words), TILE, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, n, (double*)out);
  return (int)cudaGetLastError();
}
