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
//                     rows of 2 B to any width, moved 16 bytes a lane where
//                     the row width and the pointers allow (else 8, 4 or 2).
//                     Warp-tiled: a warp loads a tile's indices in one
//                     coalesced load (one lane per row of 32) and hands
//                     each lane its row's index with __shfl_sync; the
//                     lanes' items are the tile's output vectors in order,
//                     so every store is coalesced (and streaming: L2 evicts
//                     the output first); each lane starts its 1 or
//                     GATHER_UNROLL row loads before its first store, the
//                     more only where the work's size pays for the
//                     registers (a kernel each). 4-byte rows go 4
//                     consecutive queries a lane (one 16-B index load, four
//                     element loads, one 16-B store). No 64-bit division:
//                     shifts where vpr is a power of two, else one 32-bit
//                     division a batch. One batch a warp in a grid-stride
//                     loop; few batches spread over every SM, a few warps a
//                     block. Bound by bytes: each distinct table row read
//                     once, the rows written, 4 Q of index, at 3.35 TB/s; a
//                     table in the 50 MB L2 is served from there, and the
//                     small cases sit on the launch floor (probe_empty).
//   probe_slab_copy   stages rows [off, off + G) of x for every offset into
//                     shared memory and writes either the slab's first 4
//                     bytes (slab mode) or its first BQ rows (window mode).
//                     Every slab is staged in full, as the TPU probes stage
//                     theirs; an offset outside [0, N - G] reads as an
//                     all-zero slab and loads nothing. A persistent grid
//                     (blocks per SM from the occupancy API x the SM count,
//                     taken once, with the shared memory attribute) splits
//                     the slabs evenly; in each block one lane of a producer
//                     warp starts TMA bulk copies (cp.async.bulk, no tensor
//                     map) into a ring of SLAB_STAGES stages of
//                     SLAB_STAGE_BYTES, each completing on its stage's
//                     "full" mbarrier, and SLAB_CONSUMER_WARPS consumer
//                     warps wait on that barrier's parity, write their rows
//                     with 16-B streaming stores and release the stage on
//                     its "empty" mbarrier. A slab larger than a stage is cut
//                     into chunks of one stage; smaller slabs share a stage,
//                     up to SLAB_MAX_PER_FILL a fill, so a slab of any size
//                     stages. Bound by the distinct table bytes at 3.35
//                     TB/s; staging every slab moves S G row bytes from L2,
//                     64x the distinct bytes at the 512-row windows.
//   probe_empty       copies one (8, 128) float32 tile: the cost of one
//                     launch.
//
// The constants below are the fastest of those measured on the H100
// (PERF.md §6).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// entry points, loaded with ctypes; see link_tpu_torch/ops/kernels.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int GATHER_UNROLL = 4;         // most row loads a lane has in flight
constexpr int SLAB_STAGES = 4;           // stages of the ring
constexpr int SLAB_STAGE_BYTES = 16384;  // bytes of one stage
constexpr int SLAB_CONSUMER_WARPS = 4;   // warps that write and release a stage
constexpr int SLAB_MAX_PER_FILL = 32;    // slabs one fill of a stage holds at most

constexpr int NT = 256;   // threads of a gather block at most, and of the
                          // empty launch (one float4 each: the 8 x 128 tile)
constexpr unsigned FULL = 0xffffffffu;

static_assert(SLAB_STAGE_BYTES % 16 == 0 && SLAB_STAGES >= 2,
              "stages of whole 16-byte vectors, at least two");

struct Grid {
  int blocks;   // blocks of the kernel the card holds at once; 0 on an error
  int sms;
  int err;
};

// The blocks of `kernel` the card holds at once: blocks per SM from the
// occupancy API times the SM count (taken once per kernel by the callers).
Grid resident(const void* kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();            // clear it: the next launch starts clean
    return Grid{0, 0, (int)e};
  }
  if (sms * per_sm == 0)
    return Grid{0, 0, (int)cudaErrorInvalidConfiguration};
  return Grid{sms * per_sm, sms, 0};
}

// ---------------------------------------------------------------------------
// probe_row_gather

// Stores that L2 evicts first: the output is written once and read by no
// one here, and should not push the table out of L2.
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(uint2* p, uint2 v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(uint32_t* p, uint32_t v) {
  __stcs(p, v);
}
__device__ __forceinline__ void st_stream(uint16_t* p, uint16_t v) {
  __stcs(p, v);
}


// A warp takes batches of P items a lane (1 or GATHER_UNROLL, a template
// argument, so that the kernel of one item holds few registers and the
// card more of its warps). A batch is chunk c of a tile of 32 rows: lane L
// holds the index of the tile's row L, and item k of the tile
// (k = c * P + j < vpr, j < P) is output vector i = 32 k + L: row i / vpr,
// vector i % vpr, so each store is coalesced. The lane's first item of the
// chunk comes from its first of the tile by one multiply and one 32-bit
// division a batch (a shift where vpr is a power of two), and each next
// one by adding 32 / vpr rows and 32 % vpr vectors with a carry.
// a / d as a shift where d = 2^lg (lg >= 0), else a 32-bit division
__device__ __forceinline__ int quo(int a, int d, int lg) {
  return lg >= 0 ? a >> lg : a / d;
}

template <typename V, int P>
__global__ void __launch_bounds__(NT)
row_gather_kernel(const V* __restrict__ x, int n, int vpr, int vlg,
                  const int* __restrict__ idx, long long q, unsigned chunks,
                  int clg, long long batches, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x +
                           threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const int r0 = quo(lane, vpr, vlg), v0 = lane - r0 * vpr;  // item 0
  const int dr = quo(32, vpr, vlg), dv = 32 - dr * vpr;      // an item on
  const int cr = quo(32 * P, vpr, vlg), cv = 32 * P - cr * vpr;
  for (long long b = first; b < batches; b += warps) {     // b < 2^32
    const unsigned tile = clg >= 0 ? (unsigned)b >> clg
                                   : (unsigned)b / chunks;
    const int c = (int)((unsigned)b - tile * chunks);      // chunk c of it
    const long long row0 = 32LL * tile;
    const int mine = row0 + lane < q ? __ldg(idx + row0 + lane) : -1;
    const long long left = q - row0;               // rows of this tile
    const int k0 = c * P;
    int vec = v0 + c * cv;
    int row = r0 + c * cr + quo(vec, vpr, vlg);
    vec -= quo(vec, vpr, vlg) * vpr;
    V val[P];
    unsigned live = 0;                             // items j to store
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (k0 + j < vpr) {                          // the same in every lane
        const int src = __shfl_sync(FULL, mine, row);
        val[j] = src >= 0 && src < n
                     ? __ldg(x + (long long)src * vpr + vec) : V{};
        live |= (unsigned)(row < left) << j;
      }
      vec += dv;
      row += dr;
      if (vec >= vpr) {
        vec -= vpr;
        ++row;
      }
    }
    V* o = out + row0 * vpr + lane;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (live >> j & 1) st_stream(o + 32LL * (k0 + j), val[j]);
  }
}

// 4-byte rows with idx and out 16-byte aligned: a lane takes 4 consecutive
// queries (one 16-byte index load, four element loads, one 16-byte store).
__global__ void __launch_bounds__(NT)
gather4_kernel(const uint32_t* __restrict__ x, int n, int, int,
               const int* __restrict__ idx, long long q, unsigned, int,
               long long batches, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x +
                           threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long b = first; b < batches; b += warps) {
    const long long r = b * 128 + 4 * lane;
    int id[4];
    if (r + 4 <= q) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx + r));
      id[0] = i4.x;
      id[1] = i4.y;
      id[2] = i4.z;
      id[3] = i4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) id[j] = r + j < q ? idx[r + j] : -1;
    }
    uint32_t val[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      val[j] = id[j] >= 0 && id[j] < n ? __ldg(x + id[j]) : 0u;
    if (r + 4 <= q) {
      st_stream(reinterpret_cast<uint4*>(out + r),
                make_uint4(val[0], val[1], val[2], val[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r + j < q) st_stream(out + r + j, val[j]);
    }
  }
}

// log2(d) where d is a power of two, else -1
int log2_or(int d) {
  if (d <= 0 || (d & (d - 1))) return -1;
  int lg = 0;
  while ((1 << lg) < d) ++lg;
  return lg;
}

// Launch a gather kernel over `batches` warp batches, one batch a warp.
// Few batches spread over every SM, a few warps a block, since each waits
// on the latency of two dependent loads; many fill blocks of NT threads,
// and the card runs the blocks in waves: a grid of the resident blocks,
// whose warps walk several batches each, read 4-6% slower on the 27-tap
// plan gathers (PERF.md §6). At most 2^29 blocks: batches < 2^32 and NT /
// 32 warps a block wherever batches >= NT / 32 per SM.
template <typename V>
int launch_warps(void (*kernel)(const V*, int, int, int, const int*,
                                long long, unsigned, int, long long, V*),
                 const Grid& grid, const void* x, int n, int vpr,
                 const void* idx, long long q, unsigned chunks,
                 long long batches, void* out, cudaStream_t stream) {
  if (grid.err) return grid.err;
  if (batches > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const long long per_sm = (batches + grid.sms - 1) / grid.sms;
  const int wpb = per_sm < NT / 32 ? (int)per_sm : NT / 32;
  const int blocks = (int)((batches + wpb - 1) / wpb);
  kernel<<<blocks, 32 * wpb, 0, stream>>>(
      (const V*)x, n, vpr, log2_or(vpr), (const int*)idx, q, chunks,
      log2_or((int)chunks), batches, (V*)out);
  return (int)cudaGetLastError();
}

template <typename V, int P>
int launch_items(const void* x, int n, int vpr, const void* idx, long long q,
                 void* out, cudaStream_t stream) {
  static const Grid grid =
      resident((const void*)row_gather_kernel<V, P>, NT, 0);
  const unsigned chunks = (vpr + P - 1) / P;
  const long long batches = (q + 31) / 32 * chunks;
  return launch_warps<V>(row_gather_kernel<V, P>, grid, x, n, vpr, idx, q,
                         chunks, batches, out, stream);
}

// Items a lane takes a batch: GATHER_UNROLL where the work is at least 32
// waves of the card's resident lanes at one item and the rows hold at
// least that many vectors, else one. The kernel of more items holds more
// registers (ptxas's counts in chip_smoke.py's build log), so the card
// holds fewer of its warps; a gather of fewer waves loses more to that than
// it gains from the loads in flight (PERF.md §6).
template <typename V>
int launch_gather(const void* x, int n, int row_bytes, const void* idx,
                  long long q, void* out, cudaStream_t stream) {
  static const Grid card = resident((const void*)row_gather_kernel<V, 1>,
                                    NT, 0);
  if (card.err) return card.err;
  const int vpr = row_bytes / (int)sizeof(V);
  const long long lanes = (long long)card.blocks * NT;
  if (vpr >= GATHER_UNROLL && q * vpr >= 32 * lanes)
    return launch_items<V, GATHER_UNROLL>(x, n, vpr, idx, q, out, stream);
  return launch_items<V, 1>(x, n, vpr, idx, q, out, stream);
}

int launch_gather4(const void* x, int n, const void* idx, long long q,
                   void* out, cudaStream_t stream) {
  static const Grid grid = resident((const void*)gather4_kernel, NT, 0);
  return launch_warps<uint32_t>(gather4_kernel, grid, x, n, 1, idx, q, 1,
                                (q + 127) / 128, out, stream);
}

// ---------------------------------------------------------------------------
// probe_slab_copy

constexpr int SLAB_NT = 32 * (1 + SLAB_CONSUMER_WARPS);
// the stages, then the "full" and "empty" barriers, then each stage's
// offsets (-1: a slab outside the table)
constexpr size_t SLAB_SMEM = (size_t)SLAB_STAGES * SLAB_STAGE_BYTES +
                             SLAB_STAGES * (16 + 4 * SLAB_MAX_PER_FILL);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// one arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The fills of one block: the block's slabs [lo, hi) in order. A slab of
// at most one stage shares a fill with the slabs after it (up to
// SLAB_MAX_PER_FILL, as many as the stage holds); a larger slab takes one
// fill per chunk of SLAB_STAGE_BYTES. Fill f goes to stage f % SLAB_STAGES
// in round f / SLAB_STAGES, whose parity both barriers of the stage track.
struct Fills {
  long long slab_bytes;
  int per_fill;            // slabs a fill of whole slabs holds
  int hi;
  int first;               // first slab of the fill at hand
  int count;               // its slabs
  long long byte0;         // the fill's first byte within each slab
  long long bytes;         // the fill's bytes of each slab
  int stage;
  uint32_t phase;          // parity of the stage's round

  __device__ Fills(long long slab, int lo, int hi_) : slab_bytes(slab),
      hi(hi_), first(lo), byte0(0), stage(0), phase(0) {
    const bool whole = slab <= SLAB_STAGE_BYTES;
    const int fit = whole ? (int)(SLAB_STAGE_BYTES / slab) : 1;
    per_fill = fit < SLAB_MAX_PER_FILL ? fit : SLAB_MAX_PER_FILL;
    set();
  }
  __device__ bool more() const { return first < hi; }
  __device__ void set() {
    const int left = hi - first;
    if (slab_bytes <= SLAB_STAGE_BYTES) {
      count = left < per_fill ? left : per_fill;
      bytes = slab_bytes;
    } else {
      count = 1;
      const long long rest = slab_bytes - byte0;
      bytes = rest < SLAB_STAGE_BYTES ? rest : SLAB_STAGE_BYTES;
    }
  }
  __device__ void next() {
    if (slab_bytes <= SLAB_STAGE_BYTES) {
      first += count;
    } else if ((byte0 += bytes) == slab_bytes) {
      byte0 = 0;
      ++first;
    }
    if (++stage == SLAB_STAGES) {
      stage = 0;
      phase ^= 1;
    }
    set();
  }
};

__global__ void __launch_bounds__(SLAB_NT)
slab_copy_kernel(const char* __restrict__ x, int n, int row_bytes,
                 const int* __restrict__ offs, int s, int g, int out_rows,
                 char* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)SLAB_STAGES * SLAB_STAGE_BYTES);
  uint64_t* empty = full + SLAB_STAGES;
  int* stage_offs = reinterpret_cast<int*>(empty + SLAB_STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this block's slabs: S split as evenly as the grid allows
  const int per = s / (int)gridDim.x, rem = s % (int)gridDim.x;
  const int b = blockIdx.x;
  const int lo = b * per + (b < rem ? b : rem);
  const int hi = lo + per + (b < rem ? 1 : 0);
  const long long slab = (long long)g * row_bytes;

  if (threadIdx.x == 0) {
    for (int i = 0; i < SLAB_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, SLAB_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Fills f(slab, lo, hi);
  if (warp == 0) {
    // producer: lane j reads the offset of the fill's slab j; lane 0 starts
    // the copies
    for (int k = 0; f.more(); ++k, f.next()) {
      int off = -1;
      if (lane < f.count) {
        const int o = offs[f.first + lane];
        if (o >= 0 && (long long)o + g <= n) off = o;
      }
      const unsigned hits = __ballot_sync(FULL, off >= 0);
      if (k >= SLAB_STAGES) mbar_wait(empty + f.stage, f.phase ^ 1);
      if (lane < f.count) stage_offs[f.stage * SLAB_MAX_PER_FILL + lane] = off;
      __syncwarp();
      char* dst = smem + (size_t)f.stage * SLAB_STAGE_BYTES;
      if (lane == 0)
        mbar_arrive_expect(full + f.stage, (uint32_t)(__popc(hits) * f.bytes));
      for (int j = 0; j < f.count; ++j) {
        const int o = __shfl_sync(FULL, off, j);
        if (lane == 0 && o >= 0)
          bulk_load(dst + j * f.bytes, x + (long long)o * row_bytes + f.byte0,
                    (uint32_t)f.bytes, full + f.stage);
      }
    }
    return;
  }

  // consumers
  const int ct = threadIdx.x - 32;
  const long long ob = (long long)out_rows * row_bytes;
  for (; f.more(); f.next()) {
    mbar_wait(full + f.stage, f.phase);
    const char* src = smem + (size_t)f.stage * SLAB_STAGE_BYTES;
    const int* so = stage_offs + f.stage * SLAB_MAX_PER_FILL;
    if (out_rows == 0) {                 // slab mode: the slab's first word
      if (f.byte0 == 0 && ct < f.count)
        reinterpret_cast<uint32_t*>(out)[f.first + ct] =
            so[ct] >= 0 ? *reinterpret_cast<const uint32_t*>(src + ct * f.bytes)
                        : 0u;
    } else if (f.byte0 < ob) {           // window mode: the first BQ rows
      const long long rest = ob - f.byte0;
      const int n16 = (int)((f.bytes < rest ? f.bytes : rest) / 16);
      for (int j = 0; j < f.count; ++j) {
        uint4* dst = reinterpret_cast<uint4*>(out + (f.first + j) * ob +
                                              f.byte0);
        const uint4* sj = reinterpret_cast<const uint4*>(src + j * f.bytes);
        const bool in = so[j] >= 0;
        for (int v = ct; v < n16; v += 32 * SLAB_CONSUMER_WARPS)
          st_stream(dst + v, in ? sj[v] : make_uint4(0, 0, 0, 0));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + f.stage);
  }
}

// The persistent grid, and the shared memory attribute, set once.
const Grid& slab_grid() {
  static const Grid grid = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SLAB_SMEM);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return Grid{0, 0, (int)e};
    }
    return resident((const void*)slab_copy_kernel, SLAB_NT, SLAB_SMEM);
  }();
  return grid;
}

__global__ void empty_kernel(const float4* __restrict__ x,
                             float4* __restrict__ out) {
  out[threadIdx.x] = x[threadIdx.x];
}

}  // namespace

// x (n rows of row_bytes), idx (q,) int32, out (q rows of row_bytes). The
// vector width is the widest of 16, 8, 4, 2 bytes that divides row_bytes
// and both base addresses; 4-byte rows with idx and out 16-byte aligned
// take gather4_kernel.
extern "C" int probe_row_gather(const void* x, int n, int row_bytes,
                                const void* idx, long long q, void* out,
                                void* stream) {
  if (n < 0 || q < 0 || row_bytes <= 0 || row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t mix = (uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes;
  if (row_bytes == 4 && (uintptr_t)x % 4 == 0 &&
      ((uintptr_t)idx | (uintptr_t)out) % 16 == 0)
    return launch_gather4(x, n, idx, q, out, s);
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
  const Grid& grid = slab_grid();
  if (grid.err) return grid.err;
  const int blocks = s < grid.blocks ? s : grid.blocks;
  slab_copy_kernel<<<blocks, SLAB_NT, SLAB_SMEM, (cudaStream_t)stream>>>(
      (const char*)x, n, row_bytes, (const int*)offs, s, g, out_rows,
      (char*)out);
  return (int)cudaGetLastError();
}

// x and out: one (8, 128) float32 tile each.
extern "C" int probe_empty(const void* x, void* out, void* stream) {
  empty_kernel<<<1, NT, 0, (cudaStream_t)stream>>>((const float4*)x,
                                                   (float4*)out);
  return (int)cudaGetLastError();
}
