// Native rotated-box BEV overlap + NMS (host post-processing path).
//
// A copy of link_tpu/native/nms.cpp, with the same C ABI, built and loaded
// by link_tpu_torch/native/__init__.py (the port imports nothing of the JAX
// package). It is the C++ form of the reference's rotated-rectangle
// intersection (detection/det3d/ops/iou3d_nms/src/iou3d_nms_kernel.cu):
// Sutherland-Hodgman clipping in double precision and greedy suppression.
// csrc/rotated_nms.cu runs the same clip on the card.
//
// Box layout: (N, 7) float32 [x y z w l h yaw] (pcdet convention; overlap
// uses the BEV rectangle (x, y, w, l, yaw)).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

// corners of a rotated rectangle, counter-clockwise template order.
// Rotation sense matches the det3d convention used repo-wide
// (ops/box_np.center_to_corner_box2d, reference box_np_ops.rotation_2d:
// row-vector `corners @ [[c,-s],[s,c]]` = R(-yaw)).
static void box_corners(const float* b, P2* c) {
  const double cx = b[0], cy = b[1], hw = b[3] * 0.5, hl = b[4] * 0.5;
  const double cs = std::cos((double)b[6]), sn = std::sin((double)b[6]);
  const double dx[4] = {-hw, hw, hw, -hw};
  const double dy[4] = {-hl, -hl, hl, hl};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + dx[i] * cs + dy[i] * sn;
    c[i].y = cy - dx[i] * sn + dy[i] * cs;
  }
}

static double polygon_area(const P2* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::fabs(a) * 0.5;
}

// Sutherland–Hodgman clip of subject polygon by convex clip polygon (CCW).
static int clip_polygon(const P2* subj, int ns, const P2* clip, int nc,
                        P2* out) {
  P2 buf1[16], buf2[16];
  int n = ns;
  std::memcpy(buf1, subj, sizeof(P2) * ns);
  P2* in = buf1;
  P2* ot = buf2;
  for (int e = 0; e < nc && n > 0; ++e) {
    const P2 a = clip[e];
    const P2 b = clip[(e + 1) % nc];
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
    std::swap(in, ot);
  }
  std::memcpy(out, in, sizeof(P2) * n);
  return n;
}

static double bev_overlap(const float* a, const float* b) {
  P2 ca[4], cb[4], inter[16];
  box_corners(a, ca);
  box_corners(b, cb);
  int n = clip_polygon(ca, 4, cb, 4, inter);
  if (n < 3) return 0.0;
  return polygon_area(inter, n);
}

}  // namespace

extern "C" {

// Pairwise BEV IoU: boxes_a (na, 7), boxes_b (nb, 7) -> out (na * nb)
void bev_iou_matrix(const float* boxes_a, int64_t na, const float* boxes_b,
                    int64_t nb, float* out) {
  for (int64_t i = 0; i < na; ++i) {
    const float* a = boxes_a + i * 7;
    const double area_a = (double)a[3] * a[4];
    const double ra = 0.5 * std::hypot((double)a[3], (double)a[4]);
    for (int64_t j = 0; j < nb; ++j) {
      const float* b = boxes_b + j * 7;
      const double rb = 0.5 * std::hypot((double)b[3], (double)b[4]);
      const double d = std::hypot((double)b[0] - a[0], (double)b[1] - a[1]);
      float v = 0.f;
      if (d <= ra + rb) {
        const double inter = bev_overlap(a, b);
        const double uni = area_a + (double)b[3] * b[4] - inter;
        if (uni > 0) v = (float)(inter / uni);
      }
      out[i * nb + j] = v;
    }
  }
}

// Greedy rotated NMS. boxes (n, 7) MUST already be sorted by score desc.
// keep_out: preallocated int64[n]; returns number kept.
int64_t rotate_nms(const float* boxes, int64_t n, float thresh,
                   int64_t post_max, int64_t* keep_out) {
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<double> areas(n), rads(n);
  for (int64_t i = 0; i < n; ++i) {
    areas[i] = (double)boxes[i * 7 + 3] * boxes[i * 7 + 4];
    rads[i] = 0.5 * std::hypot((double)boxes[i * 7 + 3],
                               (double)boxes[i * 7 + 4]);
  }
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    if (post_max > 0 && kept >= post_max) break;
    const float* a = boxes + i * 7;
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* b = boxes + j * 7;
      const double d = std::hypot((double)b[0] - a[0], (double)b[1] - a[1]);
      if (d > rads[i] + rads[j]) continue;
      const double inter = bev_overlap(a, b);
      const double uni = areas[i] + areas[j] - inter;
      if (uni > 0 && inter / uni > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// 3D IoU (BEV overlap x z-extent intersection) for (n,7)+(m,7) boxes.
void iou3d_matrix(const float* boxes_a, int64_t na, const float* boxes_b,
                  int64_t nb, float* out) {
  for (int64_t i = 0; i < na; ++i) {
    const float* a = boxes_a + i * 7;
    const double va = (double)a[3] * a[4] * a[5];
    const double az0 = a[2] - a[5] * 0.5, az1 = a[2] + a[5] * 0.5;
    for (int64_t j = 0; j < nb; ++j) {
      const float* b = boxes_b + j * 7;
      const double bz0 = b[2] - b[5] * 0.5, bz1 = b[2] + b[5] * 0.5;
      const double zi = std::max(
          0.0, std::min(az1, bz1) - std::max(az0, bz0));
      float v = 0.f;
      if (zi > 0) {
        const double inter = bev_overlap(a, b) * zi;
        const double vb = (double)b[3] * b[4] * b[5];
        const double uni = va + vb - inter;
        if (uni > 0) v = (float)(inter / uni);
      }
      out[i * nb + j] = v;
    }
  }
}

}  // extern "C"
