// sorted_join: the joins of the sparse conv plans, queries formed in the
// kernel.
//
// Replaces the Pallas kernel `pallas_join` (link_tpu/ops/pallas_kernels.py:
// 62-89, body `_join_kernel` :48-59, search `_lower_bound_in_vmem` :29-45)
// together with the XLA fusion around it that forms the queries
// (link_tpu/sparse/coords.py:369-391, CoordTable.query) and the window
// form's grouped query (:962-1110, grouped_window_query).
//
// Input: a table of N packed keys (t_hi, t_lo), sorted lexicographically,
// with perm (N,) the original row of each; M base rows (x, y, z, b) int32;
// an integer multiplier (mx, my, mz) on the base xyz; K tap offsets. Query
// (k, m) is pack(base[m].xyz * mult + offset[k], base[m].b) under the rules
// of `pack_coords` (link_tpu_torch/ops/kernels.py): OFFSET_XY / OFFSET_Z
// shifts, 14/14/12-bit fields, batch >= 0, anything else packs to
// (INT32_MAX, INT32_MAX). int32 arithmetic wraps as PyTorch's does. Modes:
//
//   0 exact:       out (K, M): perm[lb] on an exact match, else -1; a query
//                  whose hi is INT32_MAX always misses.
//   1 lower bound: out (K, M): lb clamped to n - 1, for every query.
//   2 window:      the three arrays of the window-form plan over the taps
//                  grouped by (dy, dz): in_idx (K, M) as mode 0; base_pos
//                  (G, M), the lower bound of each group's first tap (its
//                  anchor) clamped to n - 1, with a padding anchor (hi ==
//                  INT32_MAX) pinned to the group's largest valid base over
//                  all M rows; slot (K, M) int8, in_idx - base_pos of the
//                  tap's group on a hit (wrapped to 8 bits, as a cast), else
//                  -1. The pinning needs a maximum over all rows: the join
//                  kernel writes each block's maxima and a flag, and a
//                  second small kernel (`join_pin_kernel`) rewrites the rows
//                  of the flagged blocks only.
//
// What bounds it on the H100, and what the design does about it. The least
// bytes are the base rows once (16 B), the outputs once and the table's
// keys (and perm) once; at the seg stem (M = N = 84,992, K = 27) that is
// 11.6 MB, 3.5 us at 3.35 TB/s. The queries themselves never touch memory:
// one thread per base row reads its 16-byte row once and forms all K keys
// in registers (the taps of a (dy, dz) group pack y, z and the batch once
// and add their x), and stores are K-major, so a warp's 32 consecutive
// rows write 128 contiguous bytes per tap. What is left is a chain of
// dependent probes into a 1-2 MB table that lives in L2, and the
// instructions that walk it; against them:
//   * latency is hidden by warps in flight: where the 32-row tiles alone
//     would not fill the card's resident warps (a seg level of 85k rows is
//     2,656 warps, against 132 x 48), each tile's tap groups are split
//     over up to G warps, each with a shorter chain;
//   * a warp brackets its searches: the callers' base rows are in key
//     order, and one offset keeps valid keys in order, so the lower bounds
//     of lanes 0 and 31 bound the whole warp's for a tap group. One full
//     search per warp finds both bounds of up to 16 groups at once (two
//     lanes per group); each lane then searches inside the bracket (~32
//     rows, whose lines stay in L1). A ballot checks the order of the keys
//     per group; a warp whose keys are out of order (unsorted base rows,
//     a padding row or an out-of-range query in the middle) searches the
//     whole table per lane instead, so the result is exact for any input;
//   * a full search resolves its top levels in shared memory, in a copy of
//     every 2^s-th key (at most kMaxSamples, loaded by each block once);
//     the rest run in L2. The copy is kept small: every block loads it,
//     and the levels it saves would mostly hit in L1;
//   * taps of one group differ only in x, so a tap's bound is at or after
//     the previous tap's when its key is not smaller (checked): it gallops
//     forward from there, starting from the key already in hand, so the
//     next tap of a run usually costs one probe and its hit test none;
//     only a hit loads perm.
// The window form's pinning runs one block per (join block, group), so its
// dependent loads do not chain over the groups. The kernel allocates
// nothing: the wrapper passes the outputs and the pinning's scratch (one
// G + 1 int32 row per block), and the offsets as a kernel parameter (no
// host-to-device copy).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry point, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>

namespace {

constexpr int kInt32Max = 2147483647;
constexpr int kThreads = 256;     // kernels.JOIN_BLOCK_WARPS * 32
constexpr int kMaxTaps = 128;     // kernels.JOIN_MAX_TAPS
constexpr int kMaxGroups = 64;    // kernels.JOIN_MAX_GROUPS
constexpr int kMaxSamples = 128;  // sampled keys in shared memory
constexpr int kMinShift = 5;       // sample at least every 32nd key
constexpr int kResidentWarps = 48;  // per SM: 6 blocks of 8 warps at 40 regs
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kKeyPastEnd = 0x7fffffffffffffffLL;  // above every key

// pack_coords' bit budget (link_tpu_torch/ops/kernels.py)
constexpr int kXBits = 14;
constexpr int kZBits = 12;
constexpr int kOffsetXY = 512;
constexpr int kOffsetZ = 512;
constexpr int kSpanX = 1 << 14;
constexpr int kSpanY = 1 << 14;
constexpr int kSpanZ = 1 << 12;

enum { kExact = 0, kLowerBound = 1, kWindow = 2 };

// The taps, grouped: group j's taps are positions gstart[j] .. gstart[j+1]
// of `order` (tap ids) and `off` (their offsets), x ascending in a group.
struct Taps {
  int k, g, mode;
  int mult[3];
  int gstart[kMaxGroups + 1];
  int order[kMaxTaps];
  int off[kMaxTaps][3];
};

// (hi, lo) as one signed 64-bit key: lo is never negative, so the order of
// the 64-bit keys is the lexicographic order of the pairs.
__device__ __forceinline__ long long make_key(int hi, int lo) {
  return ((long long)hi << 32) | (unsigned)lo;
}

__device__ __forceinline__ int key_hi(long long key) {
  return (int)(key >> 32);
}

__device__ __forceinline__ long long table_key(const int* __restrict__ t_hi,
                                               const int* __restrict__ t_lo,
                                               int i) {
  return make_key(__ldg(t_hi + i), __ldg(t_lo + i));
}

__device__ __forceinline__ long long pack_query(int4 b, const Taps& tp,
                                                int pos) {
  const int x = (int)((unsigned)b.x * (unsigned)tp.mult[0]
                      + (unsigned)tp.off[pos][0] + (unsigned)kOffsetXY);
  const int y = (int)((unsigned)b.y * (unsigned)tp.mult[1]
                      + (unsigned)tp.off[pos][1] + (unsigned)kOffsetXY);
  const int z = (int)((unsigned)b.z * (unsigned)tp.mult[2]
                      + (unsigned)tp.off[pos][2] + (unsigned)kOffsetZ);
  const bool valid = x >= 0 && x < kSpanX && y >= 0 && y < kSpanY && z >= 0
                     && z < kSpanZ && b.w >= 0;
  if (!valid) return make_key(kInt32Max, kInt32Max);
  const int hi = (int)(((unsigned)b.w << kZBits)
                       | ((unsigned)z & (kSpanZ - 1)));
  const int lo = (int)(((unsigned)y << kXBits) | ((unsigned)x & (kSpanX - 1)));
  return make_key(hi, lo);
}

// Lower bound of q in [lo, hi) of the table, given that it lies in
// [lo, hi] (hi when every key there is below q).
__device__ __forceinline__ int lb_range(const int* __restrict__ t_hi,
                                        const int* __restrict__ t_lo,
                                        long long q, int lo, int hi) {
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (table_key(t_hi, t_lo, mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Lower bound of q over the whole table: the sampled keys in shared memory
// (samples[j] = key[j << shift]) narrow it to one stride, then L2.
__device__ __forceinline__ int lb_full(const long long* samples, int ns,
                                       int shift,
                                       const int* __restrict__ t_hi,
                                       const int* __restrict__ t_lo,
                                       long long q, int n) {
  int a = 0, b = ns;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (samples[mid] < q) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  // key[(a - 1) << shift] < q <= key[a << shift]
  const int lo = a == 0 ? 0 : ((a - 1) << shift) + 1;
  const int hi = a == ns ? n : (a << shift);
  return lb_range(t_hi, t_lo, q, lo, hi);
}

// Lower bound of q given that it is at or after `start`, whose key k_start
// is known (kKeyPastEnd at n): gallop forward. Also gives the key there.
__device__ __forceinline__ int lb_gallop(const int* __restrict__ t_hi,
                                         const int* __restrict__ t_lo,
                                         long long q, int start,
                                         long long k_start, int n,
                                         long long& k_out) {
  if (k_start >= q) {
    k_out = k_start;
    return start;
  }
  int lo = start;  // key[lo] < q
  int step = 1;
  while (true) {
    const int probe = lo + step;
    int p;
    if (probe >= n) {
      p = lb_range(t_hi, t_lo, q, lo + 1, n);
    } else {
      const long long kp = table_key(t_hi, t_lo, probe);
      if (kp < q) {
        lo = probe;
        step <<= 1;
        continue;
      }
      if (step == 1) {
        k_out = kp;
        return probe;
      }
      p = lb_range(t_hi, t_lo, q, lo + 1, probe);
    }
    k_out = p < n ? table_key(t_hi, t_lo, p) : kKeyPastEnd;
    return p;
  }
}

__global__ void __launch_bounds__(kThreads)
sorted_join_kernel(const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                   const int* __restrict__ perm, int n, int shift, int ns,
                   const int4* __restrict__ base, int m, const Taps tp,
                   int slices, int* __restrict__ out,
                   int* __restrict__ base_pos, signed char* __restrict__ slot,
                   int* __restrict__ partial) {
  __shared__ long long samples[kMaxSamples];
  __shared__ int group_max[kMaxGroups];
  for (int j = threadIdx.x; j < ns; j += kThreads) {
    samples[j] = table_key(t_hi, t_lo, j << shift);
  }
  for (int j = threadIdx.x; j < tp.g; j += kThreads) group_max[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // warp w takes the 32 rows of tile w / slices and the groups g with
  // g % slices == w % slices
  const long long warp = (long long)blockIdx.x * (kThreads / 32)
                         + (threadIdx.x >> 5);
  const long long tile = warp / slices;
  const int slice = (int)(warp - tile * slices);
  const int ng = (tp.g - slice + slices - 1) / slices;  // this warp's groups
  const long long row0 = tile * 32;
  const long long row = row0 + lane;
  const bool active = row < m;
  int pad_anchor = 0;  // this thread wrote a padding anchor (window mode)
  if (row0 < m) {      // warp-uniform
    const int r = active ? (int)row : m - 1;
    const size_t mm = (size_t)m;
    const int4 b = __ldg(base + r);
    // the warp's last row in range: its bounds close the bracket
    const int last = (int)min(31LL, (long long)m - 1 - row0);
    const int4 b_first = make_int4(__shfl_sync(kFull, b.x, 0),
                                   __shfl_sync(kFull, b.y, 0),
                                   __shfl_sync(kFull, b.z, 0),
                                   __shfl_sync(kFull, b.w, 0));
    const int4 b_end = make_int4(__shfl_sync(kFull, b.x, last),
                                 __shfl_sync(kFull, b.y, last),
                                 __shfl_sync(kFull, b.z, last),
                                 __shfl_sync(kFull, b.w, last));
    for (int i0 = 0; i0 < ng; i0 += 16) {
      // lanes j and 16 + j find the lower bounds of the anchor of the
      // warp's group i0 + j for its first and last row, in one search
      const int ij = i0 + (lane & 15);
      long long tq = make_key(0, 0);
      if (ij < ng) tq = pack_query(lane < 16 ? b_first : b_end, tp,
                                   tp.gstart[slice + ij * slices]);
      const int bound = lb_full(samples, ns, shift, t_hi, t_lo, tq, n);
      const int i_end = min(ng, i0 + 16);
      for (int gi = i0; gi < i_end; ++gi) {
        const int g = slice + gi * slices;
        const int lo_b = __shfl_sync(kFull, bound, gi - i0);
        const int hi_b = __shfl_sync(kFull, bound, 16 + gi - i0);
        const int p0 = tp.gstart[g], p1 = tp.gstart[g + 1];
        // the taps of a group share (dy, dz), so y, z and the batch pack
        // once; each tap adds its x
        const int gy = (int)((unsigned)b.y * (unsigned)tp.mult[1]
                             + (unsigned)tp.off[p0][1] + (unsigned)kOffsetXY);
        const int gz = (int)((unsigned)b.z * (unsigned)tp.mult[2]
                             + (unsigned)tp.off[p0][2] + (unsigned)kOffsetZ);
        const bool yzb_ok = gy >= 0 && gy < kSpanY && gz >= 0 && gz < kSpanZ
                            && b.w >= 0;
        const int g_hi = (int)(((unsigned)b.w << kZBits)
                               | ((unsigned)gz & (kSpanZ - 1)));
        const unsigned g_y = (unsigned)gy << kXBits;
        const unsigned bx = (unsigned)b.x * (unsigned)tp.mult[0]
                            + (unsigned)kOffsetXY;
        auto tap_key = [&](int i) {
          const int x = (int)(bx + (unsigned)tp.off[i][0]);
          return yzb_ok && x >= 0 && x < kSpanX
                     ? make_key(g_hi, (int)(g_y | (unsigned)x))
                     : make_key(kInt32Max, kInt32Max);
        };
        const long long q = tap_key(p0);
        const long long q_prev = __shfl_up_sync(kFull, q, 1);
        const bool ordered = __all_sync(kFull, lane == 0 || q_prev <= q);
        const int p = ordered ? lb_range(t_hi, t_lo, q, lo_b, hi_b)
                              : lb_full(samples, ns, shift, t_hi, t_lo, q, n);
        if (tp.mode == kLowerBound) {
          if (active) out[(size_t)g * mm + r] = min(p, n - 1);
          continue;
        }
        int bpos = -1;
        if (tp.mode == kWindow) {
          const bool anchor_ok = key_hi(q) != kInt32Max;
          bpos = anchor_ok ? min(p, n - 1) : -1;
          if (active) base_pos[(size_t)g * mm + r] = bpos;
          const int v = __reduce_max_sync(kFull,
                                          active && anchor_ok ? bpos : 0);
          if (lane == 0 && v > 0) atomicMax(&group_max[g], v);
          pad_anchor |= active && !anchor_ok;
        }
        long long q_last = q;
        int p_last = p;
        long long k_last = p < n ? table_key(t_hi, t_lo, p) : kKeyPastEnd;
        for (int i = p0; i < p1; ++i) {
          const long long qt = i == p0 ? q : tap_key(i);
          int idx = -1;
          if (key_hi(qt) != kInt32Max) {  // a padding query misses
            long long kt;
            int pt;
            if (qt >= q_last) {
              pt = lb_gallop(t_hi, t_lo, qt, p_last, k_last, n, kt);
            } else {
              pt = lb_full(samples, ns, shift, t_hi, t_lo, qt, n);
              kt = pt < n ? table_key(t_hi, t_lo, pt) : kKeyPastEnd;
            }
            q_last = qt;
            p_last = pt;
            k_last = kt;
            if (kt == qt) idx = __ldg(perm + pt);
          }
          if (active) {
            const size_t at = (size_t)tp.order[i] * mm + r;
            out[at] = idx;
            if (tp.mode == kWindow) {
              slot[at] = (idx >= 0 && bpos >= 0) ? (signed char)(idx - bpos)
                                                 : (signed char)-1;
            }
          }
        }
      }
    }
  }
  if (tp.mode == kWindow) {
    // every thread reaches this barrier (the row test above is per warp)
    const int any_pad = __syncthreads_or(pad_anchor);
    int* mine = partial + (size_t)blockIdx.x * (tp.g + 1);
    for (int j = threadIdx.x; j < tp.g; j += kThreads) mine[j] = group_max[j];
    if (threadIdx.x == 0) mine[tp.g] = any_pad;
  }
}

// The window form's pinning, one block per (join block, group): in each
// join block that wrote a padding anchor, base_pos of such a row becomes
// the group's largest valid base over all rows (the maximum of the join
// blocks' maxima), and the slots of that group's hits in the row are taken
// against it. A block of a join block without a padding anchor returns at
// once.
__global__ void __launch_bounds__(kThreads)
join_pin_kernel(const int* __restrict__ partial, int blocks, int slices,
                int m, const Taps tp, const int* __restrict__ in_idx,
                int* __restrict__ base_pos, signed char* __restrict__ slot) {
  const int g = tp.g, j = blockIdx.y;
  // this block's rows are those of join blocks x * slices ...
  // (x + 1) * slices - 1
  int pad = 0;
  const int b_end = min(blocks, (int)(blockIdx.x + 1) * slices);
  for (int bi = blockIdx.x * slices; bi < b_end; ++bi) {
    pad |= partial[(size_t)bi * (g + 1) + g];
  }
  if (pad == 0) return;  // per block
  __shared__ int group_max;
  if (threadIdx.x == 0) group_max = 0;
  __syncthreads();
  int v = 0;
  for (int bi = threadIdx.x; bi < blocks; bi += kThreads) {
    v = max(v, __ldg(partial + (size_t)bi * (g + 1) + j));
  }
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) atomicMax(&group_max, v);
  __syncthreads();
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= m) return;
  const size_t mm = (size_t)m;
  const size_t at = (size_t)j * mm + row;
  if (base_pos[at] >= 0) return;
  v = group_max;
  base_pos[at] = v;
  for (int i = tp.gstart[j]; i < tp.gstart[j + 1]; ++i) {
    const size_t t_at = (size_t)tp.order[i] * mm + row;
    const int idx = in_idx[t_at];
    if (idx >= 0) slot[t_at] = (signed char)(idx - v);
  }
}

}  // namespace

// All pointers but `taps` are device pointers; base is (M, 4) int32, 16-byte
// aligned; n >= 1, m >= 1. `taps` (host memory) holds k, g, mx, my, mz,
// gstart[0..g], order[0..k) and off[0..k) x 3 as int32. mode 0 / 1 write
// `out` (K, M); mode 2 writes `out` (in_idx), base_pos (G, M), slot (K, M)
// and uses `partial` (ceil(M / 256) x (G + 1) int32), in two launches.
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int sorted_join(const void* t_hi, const void* t_lo, const void* perm,
                           int n, const void* base, int m, const int* taps,
                           int mode, void* out, void* base_pos, void* slot,
                           void* partial, void* stream) {
  Taps tp;
  tp.k = taps[0];
  tp.g = taps[1];
  tp.mode = mode;
  if (mode < kExact || mode > kWindow || n < 1 || m < 1 || tp.k < 1
      || tp.k > kMaxTaps || tp.g < 1 || tp.g > kMaxGroups) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) tp.mult[a] = taps[2 + a];
  const int* gs = taps + 5;
  for (int j = 0; j <= tp.g; ++j) tp.gstart[j] = gs[j];
  if (tp.gstart[0] != 0 || tp.gstart[tp.g] != tp.k) {
    return (int)cudaErrorInvalidValue;
  }
  const int* order = gs + tp.g + 1;
  const int* off = order + tp.k;
  for (int i = 0; i < tp.k; ++i) {
    tp.order[i] = order[i];
    for (int a = 0; a < 3; ++a) tp.off[i][a] = off[3 * i + a];
  }
  int shift = kMinShift;
  while (((long long)n + (1LL << shift) - 1) >> shift > kMaxSamples) ++shift;
  const int ns = (int)(((long long)n + (1LL << shift) - 1) >> shift);
  // split each tile's groups over `slices` warps when the tiles alone
  // would not fill the card's resident warps (kResidentWarps per SM)
  const long long tiles = ((long long)m + 31) / 32;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int slices = (int)max(
      1LL, min((long long)tp.g, (long long)sms * kResidentWarps / tiles));
  const int warps_per_block = kThreads / 32;
  const int blocks = (int)((tiles * slices + warps_per_block - 1)
                           / warps_per_block);
  const int pin_blocks = (int)(((long long)m + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  sorted_join_kernel<<<blocks, kThreads, 0, s>>>(
      (const int*)t_hi, (const int*)t_lo, (const int*)perm, n, shift, ns,
      (const int4*)base, m, tp, slices, (int*)out, (int*)base_pos,
      (signed char*)slot, (int*)partial);
  if (mode == kWindow) {
    join_pin_kernel<<<dim3(pin_blocks, tp.g), kThreads, 0, s>>>(
        (const int*)partial, blocks, slices, m, tp, (const int*)out,
        (int*)base_pos,
        (signed char*)slot);
  }
  return (int)cudaGetLastError();
}
