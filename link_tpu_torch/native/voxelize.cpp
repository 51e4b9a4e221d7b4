// Hard voxelization, two passes over points with direct sorted emit.
//
// A copy of link_tpu/native/voxelize.cpp, with the same C ABI, built and
// loaded by link_tpu_torch/native/__init__.py.
//
// Native twin of the reference's numba kernel
// (detection/det3d/ops/point_cloud/point_cloud_ops.py:8-57): each voxel
// keeps the first `max_points` points in point order, and only the first
// `max_voxels` voxels (by appearance) are kept. Instead of the
// reference's dense coor->voxelidx grid (1440*1440*41 ints = 332 MB, one
// cache miss per point), the coord->voxel map is an open-addressing hash
// table sized ~4x max_voxels (a few MB, cache-resident).
//
// The output rows are emitted SORTED by (z, y, x) — the pack-key order
// the device-side sparse engine requires (sparse/coords.py). Pass 1 only
// assigns voxel ids (no payload moves), the voxel ids are key-sorted, then
// pass 2 copies each point's payload DIRECTLY into its final sorted row:
// no scratch voxel buffer (zero + fill + permute-copy, about 3 passes over
// 32 MB); only bytes that carry points are written, and the caller's
// zeroed output pages serve as the zero padding.
//
// coord_mode selects the coordinate layout: 0 emits (z, y, x) rows
// (points_to_voxel API); 1 emits (x, y, z, b) with a constant batch
// column — the device batch layout (det_pipeline.collate_det) — so a
// single-frame serving call produces the collated batch with no further
// host copies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
// thread_local: ctypes releases the GIL for the duration of the call, so
// a loader worker thread and a serving thread may voxelize concurrently
// (inference.SingleFramePredictor beside a data loader's threads).
// Per-thread scratch keeps the capacity-reuse amortization without locks.
thread_local std::vector<int64_t> g_keys;      // hash slots: key, -1 empty
thread_local std::vector<int32_t> g_vals;      // hash slots: voxel id
thread_local std::vector<int64_t> g_vid_key;   // per-vid packed (key, vid)
thread_local std::vector<int32_t> g_vid_coord; // per-vid (z, y, x)
thread_local std::vector<int32_t> g_row_of;    // per-vid row after sort
thread_local std::vector<int32_t> g_fill;      // per-vid emitted count
thread_local std::vector<int32_t> g_pt_vid;    // per-point vid, -1 dropped
}  // namespace

extern "C" int64_t voxelize(
    const float* points, int64_t n, int64_t f,
    const float* voxel_size,   // (3,) x, y, z
    const float* pc_range,     // (6,) xmin..zmax
    const int32_t* grid,       // (3,) nx, ny, nz
    int64_t max_points, int64_t max_voxels,
    float* out_voxels,         // (>=max_voxels, max_points, f) PRE-ZEROED
    int32_t* out_coords,       // (>=max_voxels, 3|4) pre-filled pad
    int32_t* out_nppv,         // (>=max_voxels,) pre-zeroed
    int64_t coord_mode,        // 0: (z,y,x); 1: (x,y,z,b)
    int64_t batch_idx) {
  const int64_t nx = grid[0], ny = grid[1];
  int64_t cap = 4;
  while (cap < 4 * max_voxels) cap <<= 1;
  const int64_t mask = cap - 1;
  g_keys.assign(cap, -1);
  g_vals.resize(cap);
  g_vid_key.resize(max_voxels);
  g_vid_coord.resize(max_voxels * 3);
  g_pt_vid.resize(n);

  // pass 1: assign voxel ids in appearance order (no payload movement)
  int64_t n_vox = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * f;
    int64_t c[3];
    bool ok = true;
    for (int a = 0; a < 3; ++a) {
      float v = (p[a] - pc_range[a]) / voxel_size[a];
      int64_t ci = (int64_t)std::floor(v);
      if (ci < 0 || ci >= grid[a]) { ok = false; break; }
      c[a] = ci;
    }
    if (!ok) { g_pt_vid[i] = -1; continue; }
    const int64_t key = (c[2] * ny + c[1]) * nx + c[0];
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    int64_t slot = (int64_t)(h >> 32) & mask;
    int32_t vid = -1;
    while (true) {
      int64_t k = g_keys[slot];
      if (k == key) { vid = g_vals[slot]; break; }
      if (k == -1) {
        if (n_vox < max_voxels) {
          vid = (int32_t)n_vox++;
          g_keys[slot] = key;
          g_vals[slot] = vid;
          g_vid_key[vid] = key * (int64_t)max_voxels + vid;
          g_vid_coord[vid * 3 + 0] = (int32_t)c[2];
          g_vid_coord[vid * 3 + 1] = (int32_t)c[1];
          g_vid_coord[vid * 3 + 2] = (int32_t)c[0];
        }
        break;
      }
      slot = (slot + 1) & mask;
    }
    g_pt_vid[i] = vid;
  }

  // sort vids by key -> final (z, y, x)-ordered row of each voxel
  std::sort(g_vid_key.begin(), g_vid_key.begin() + n_vox);
  g_row_of.resize(n_vox);
  for (int64_t o = 0; o < n_vox; ++o)
    g_row_of[g_vid_key[o] % max_voxels] = (int32_t)o;

  // pass 2: payload straight to its sorted row; coords + counts
  g_fill.assign(n_vox, 0);
  const int64_t row = max_points * f;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t vid = g_pt_vid[i];
    if (vid < 0) continue;
    const int32_t k = g_fill[vid];
    if (k >= max_points) continue;
    g_fill[vid] = k + 1;
    std::memcpy(out_voxels + (int64_t)g_row_of[vid] * row + k * f,
                points + i * f, f * sizeof(float));
  }
  const int64_t cw = coord_mode ? 4 : 3;
  for (int64_t v = 0; v < n_vox; ++v) {
    const int64_t o = g_row_of[v];
    const int32_t* c = g_vid_coord.data() + v * 3;   // (z, y, x)
    int32_t* oc = out_coords + o * cw;
    if (coord_mode) {
      oc[0] = c[2]; oc[1] = c[1]; oc[2] = c[0];
      oc[3] = (int32_t)batch_idx;
    } else {
      oc[0] = c[0]; oc[1] = c[1]; oc[2] = c[2];
    }
    out_nppv[o] = g_fill[v];
  }
  return n_vox;
}
