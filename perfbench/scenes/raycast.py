"""Seeded street scenes and a LiDAR ray caster.

A scene is laid out in a road frame: a road along x with a gentle slope,
curbs at |y| = W, sidewalks, then terrain, building walls, vegetation
bands, poles and the boxes of nuScenes' ten classes, parked along the
curbs, driving in the lanes and walking on the sidewalks. Every solid is
an oriented box; the ground is a piecewise plane. A sensor casts its beams
(a ring of elevations by a grid of azimuths) into the scene and keeps the
nearest hit of each ray, with range noise and a few dropped returns.

The scene's layout is drawn on the host from a numpy Generator; the rays,
the hits and the noise are computed with torch on the device the caller
names (a `torch.Generator` there), so the same seed gives the same points
on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# nuScenes' ten detection classes, mean (width, length, height) in meters
# (the nuScenes training set's class means, as CenterPoint's anchors)
NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian",
                "traffic_cone")
NUSC_SIZES = {"car": (1.95, 4.62, 1.73), "truck": (2.51, 6.93, 2.84),
              "construction_vehicle": (2.85, 6.37, 3.19),
              "bus": (2.94, 10.5, 3.47), "trailer": (2.90, 12.29, 3.87),
              "barrier": (2.53, 0.50, 0.98), "motorcycle": (0.77, 2.11, 1.47),
              "bicycle": (0.60, 1.70, 1.28), "pedestrian": (0.67, 0.73, 1.77),
              "traffic_cone": (0.41, 0.41, 1.07)}

# SemanticKITTI's learning labels of the surfaces (LEARNING_MAP's targets)
SEG = {"car": 1, "bicycle": 2, "motorcycle": 3, "truck": 4, "other_vehicle": 5,
       "person": 6, "road": 9, "sidewalk": 11, "building": 13, "fence": 14,
       "vegetation": 15, "terrain": 17, "pole": 18, "traffic_sign": 19}
SEG_OF_CLASS = {"car": SEG["car"], "truck": SEG["truck"],
                "construction_vehicle": SEG["other_vehicle"],
                "bus": SEG["other_vehicle"], "trailer": SEG["other_vehicle"],
                "barrier": SEG["fence"], "motorcycle": SEG["motorcycle"],
                "bicycle": SEG["bicycle"], "pedestrian": SEG["person"],
                "traffic_cone": SEG["traffic_sign"]}
# mean reflectance of each surface label, in [0, 1]
REFLECTANCE = {1: 0.35, 2: 0.3, 3: 0.3, 4: 0.4, 5: 0.4, 6: 0.25, 9: 0.15,
               11: 0.25, 13: 0.3, 14: 0.5, 15: 0.2, 17: 0.2, 18: 0.45, 19: 0.8}

# kinds of box: a solid surface, or vegetation, whose returns scatter
SOLID, VEGETATION = 0, 1

PARKED_MIX = (("car", 0.72), ("truck", 0.08), ("construction_vehicle", 0.03),
              ("bus", 0.04), ("trailer", 0.03), ("motorcycle", 0.05),
              ("bicycle", 0.05))
MOVING_MIX = (("car", 0.75), ("truck", 0.1), ("bus", 0.07), ("trailer", 0.03),
              ("motorcycle", 0.05))


class _Boxes:
    """Box primitives as growing lists, one entry per box."""

    def __init__(self):
        self.rows = []

    def add(self, x, y, z_bottom, length, width, height, yaw, seg, kind=SOLID,
            det=-1, vx=0.0, vy=0.0):
        self.rows.append((x, y, z_bottom + height / 2, length / 2, width / 2,
                          height / 2, yaw, vx, vy, seg, kind, det))

    def arrays(self) -> Dict[str, np.ndarray]:
        a = np.asarray(self.rows, np.float64).reshape(-1, 12)
        return {"center": a[:, 0:3], "half": a[:, 3:6], "yaw": a[:, 6],
                "vel": a[:, 7:9], "seg": a[:, 9].astype(np.int64),
                "kind": a[:, 10].astype(np.int64),
                "det": a[:, 11].astype(np.int64)}


def _pick(rng: np.random.Generator, mix) -> str:
    names = [n for n, _ in mix]
    p = np.asarray([w for _, w in mix], np.float64)
    return names[int(rng.choice(len(names), p=p / p.sum()))]


def make_scene(rng: np.random.Generator, p: Dict) -> Dict:
    """Lay out one street scene in the road frame from the traffic's
    scene parameters `p` (see the traffic files). Returns the ground's
    parameters and the boxes' arrays; `det` is the nuScenes class index of
    a box that is an object of the ten classes, else -1."""
    half_w = rng.uniform(*p["road_half_width_m"])
    sidewalk = rng.uniform(*p["sidewalk_width_m"])
    curb = p["curb_height_m"]
    slope = rng.uniform(-p["slope"], p["slope"], 2)
    reach = p["scene_reach_m"]
    z0 = -p["sensor_height_m"]
    boxes = _Boxes()

    def ground_z(x, y):
        return z0 + slope[0] * x + slope[1] * y + (curb if abs(y) > half_w
                                                   else 0.0)

    for side in (-1.0, 1.0):
        # building walls behind the sidewalk, with gaps
        x = -reach - rng.uniform(0, 20)
        while x < reach:
            length = rng.uniform(*p["building_length_m"])
            setback = half_w + sidewalk + rng.uniform(*p["building_setback_m"])
            depth = rng.uniform(8, 15)
            height = rng.uniform(*p["building_height_m"])
            y = side * (setback + depth / 2)
            boxes.add(x + length / 2, y, ground_z(x, y) - 0.5, length, depth,
                      height + 0.5, rng.normal(0, 0.02), SEG["building"])
            # vegetation between sidewalk and wall, and in the gap after it
            gap = rng.uniform(*p["building_gap_m"])
            for vx0, vlen in ((x, length), (x + length, gap)):
                if rng.random() < p["vegetation_share"]:
                    vw = rng.uniform(1.0, max(1.2, setback - half_w - sidewalk))
                    vy = side * (half_w + sidewalk + vw / 2)
                    boxes.add(vx0 + vlen / 2, vy, ground_z(vx0, vy), vlen, vw,
                              rng.uniform(0.6, 3.0), 0.0, SEG["vegetation"],
                              VEGETATION)
            x += length + gap
        # poles along the sidewalk's outer edge of the road
        x = -reach + rng.uniform(0, 10)
        while x < reach:
            y = side * (half_w + 0.4)
            boxes.add(x, y, ground_z(x, y), 0.22, 0.22,
                      rng.uniform(*p["pole_height_m"]), 0.0, SEG["pole"])
            x += rng.uniform(*p["pole_spacing_m"])
        # parked vehicles in the curb lane
        x = -reach + rng.uniform(0, 8)
        while x < reach:
            name = _pick(rng, PARKED_MIX)
            w, length, h = (s * rng.uniform(0.92, 1.08)
                            for s in NUSC_SIZES[name])
            if rng.random() < p["parked_share"]:
                y = side * (half_w - w / 2 - 0.25)
                yaw = (0.0 if rng.random() < 0.5 else math.pi) + rng.normal(
                    0, 0.04)
                boxes.add(x + length / 2, y, ground_z(x, y), length, w, h, yaw,
                          SEG_OF_CLASS[name], det=NUSC_CLASSES.index(name))
            x += length + rng.uniform(0.8, 6.0)
        # moving vehicles in this side's lane, driving on the right
        for _ in range(rng.poisson(p["moving_per_lane"])):
            name = _pick(rng, MOVING_MIX)
            w, length, h = (s * rng.uniform(0.92, 1.08)
                            for s in NUSC_SIZES[name])
            x = rng.uniform(-reach, reach)
            y = side * half_w / 2 + rng.normal(0, 0.2)
            speed = rng.uniform(*p["moving_speed_mps"])
            yaw = 0.0 if side < 0 else math.pi
            boxes.add(x, y, ground_z(x, y), length, w, h, yaw,
                      SEG_OF_CLASS[name], det=NUSC_CLASSES.index(name),
                      vx=speed * math.cos(yaw), vy=speed * math.sin(yaw))
        # pedestrians on the sidewalk
        for _ in range(rng.poisson(p["pedestrians_per_side"])):
            w, length, h = (s * rng.uniform(0.9, 1.1)
                            for s in NUSC_SIZES["pedestrian"])
            x = rng.uniform(-reach, reach)
            y = side * (half_w + rng.uniform(0.6, sidewalk))
            speed = rng.uniform(-1.5, 1.5)
            yaw = 0.0 if speed >= 0 else math.pi
            boxes.add(x, y, ground_z(x, y), length, w, h, yaw, SEG["person"],
                      det=NUSC_CLASSES.index("pedestrian"), vx=speed)
        # barriers and traffic cones at the road's edge
        for name, key in (("barrier", "barriers_per_side"),
                          ("traffic_cone", "cones_per_side")):
            for _ in range(rng.poisson(p[key])):
                w, length, h = NUSC_SIZES[name]
                x = rng.uniform(-reach, reach)
                y = side * (half_w - rng.uniform(0.3, 1.5))
                boxes.add(x, y, ground_z(x, y), length, w, h,
                          rng.normal(0, 0.1), SEG_OF_CLASS[name],
                          det=NUSC_CLASSES.index(name))
    arr = boxes.arrays()
    # nothing stands on the sensor's own cell
    keep = np.hypot(arr["center"][:, 0], arr["center"][:, 1] - p.get(
        "ego_lane_y_m", 0.0)) > p["clear_radius_m"] + arr["half"][:, 0]
    arr = {k: v[keep] for k, v in arr.items()}
    return {"boxes": arr, "half_w": half_w, "sidewalk": sidewalk,
            "curb": curb, "slope": slope, "z0": z0,
            "yaw": rng.uniform(0, 2 * math.pi)}


def beam_directions(sensor: Dict, gen: torch.Generator,
                    device) -> torch.Tensor:
    """(beams * azimuths, 3) unit ray directions in the sensor frame: the
    beams' elevations evenly from `elev_top_deg` to `elev_bottom_deg`, the
    azimuths a full turn with a little jitter."""
    el = torch.linspace(math.radians(sensor["elev_top_deg"]),
                        math.radians(sensor["elev_bottom_deg"]),
                        sensor["beams"], device=device, dtype=torch.float64)
    n_az = sensor["azimuths"]
    az = torch.arange(n_az, device=device, dtype=torch.float64) * (
        2 * math.pi / n_az)
    az = az[None, :] + (torch.rand((sensor["beams"], n_az), generator=gen,
                                   device=device, dtype=torch.float64)
                        - 0.5) * (2 * math.pi / n_az) * 0.2
    el = el[:, None].expand_as(az)
    d = torch.stack([torch.cos(el) * torch.cos(az),
                     torch.cos(el) * torch.sin(az), torch.sin(el)], -1)
    return d.reshape(-1, 3)


def _box_hits(o: torch.Tensor, d: torch.Tensor, bx: Dict[str, torch.Tensor],
              chunk: int = 8192):
    """Nearest box hit of each ray: (t (R,), box index (R,), -1 for none)."""
    n = d.shape[0]
    t_best = torch.full((n,), math.inf, dtype=d.dtype, device=d.device)
    i_best = torch.full((n,), -1, dtype=torch.long, device=d.device)
    if bx["center"].shape[0] == 0:
        return t_best, i_best
    c, s = torch.cos(bx["yaw"]), torch.sin(bx["yaw"])
    half = bx["half"]
    for a in range(0, n, chunk):
        dd = d[a:a + chunk, None, :]                       # (r, 1, 3)
        p = o[None, None, :] - bx["center"][None]          # (1, B, 3)
        px = c * p[..., 0] + s * p[..., 1]
        py = -s * p[..., 0] + c * p[..., 1]
        dx = c * dd[..., 0] + s * dd[..., 1]
        dy = -s * dd[..., 0] + c * dd[..., 1]
        pl = torch.stack([px.expand(dx.shape), py.expand(dy.shape),
                          p[..., 2].expand(dx.shape)], -1)
        dl = torch.stack([dx, dy, dd[..., 2].expand(dx.shape)], -1)
        tiny = torch.full_like(dl, 1e-12)
        dl = torch.where(dl.abs() < 1e-12, tiny, dl)
        t1 = (-half[None] - pl) / dl
        t2 = (half[None] - pl) / dl
        t_in = torch.minimum(t1, t2).amax(-1)
        t_out = torch.maximum(t1, t2).amin(-1)
        ok = (t_out >= t_in) & (t_in > 1e-3)
        t = torch.where(ok, t_in, torch.full_like(t_in, math.inf))
        tm, im = t.min(1)
        t_best[a:a + chunk] = tm
        i_best[a:a + chunk] = torch.where(torch.isfinite(tm), im,
                                          torch.full_like(im, -1))
    return t_best, i_best


def _ground_hits(o: torch.Tensor, d: torch.Tensor, scene: Dict):
    """Nearest ground hit (road, curb face, sidewalk or terrain): (t,
    label)."""
    a, b = (float(v) for v in scene["slope"])
    w, z0, curb = scene["half_w"], scene["z0"], scene["curb"]
    inf = torch.full_like(d[:, 0], math.inf)
    den = d[:, 2] - a * d[:, 0] - b * d[:, 1]
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, -1e-12), den)
    out_t, out_l = inf.clone(), torch.zeros_like(d[:, 0], dtype=torch.long)
    for h, road in ((0.0, True), (curb, False)):
        t = (z0 + h + a * o[0] + b * o[1] - o[2]) / den
        y = o[1] + t * d[:, 1]
        ok = (t > 1e-3) & ((y.abs() <= w) if road else (y.abs() > w))
        t = torch.where(ok, t, inf)
        better = t < out_t
        lab = (torch.full_like(out_l, SEG["road"]) if road else torch.where(
            y.abs() <= w + scene["sidewalk"],
            torch.full_like(out_l, SEG["sidewalk"]),
            torch.full_like(out_l, SEG["terrain"])))
        out_t = torch.where(better, t, out_t)
        out_l = torch.where(better, lab, out_l)
    # the curb's vertical face, met by rays leaving the road
    side = torch.sign(d[:, 1])
    dy = torch.where(d[:, 1].abs() < 1e-12, torch.full_like(d[:, 1], 1e-12),
                     d[:, 1])
    t = (side * w - o[1]) / dy
    x = o[0] + t * d[:, 0]
    z = o[2] + t * d[:, 2]
    zr = z0 + a * x + b * side * w
    ok = (t > 1e-3) & (z >= zr) & (z <= zr + curb) & (o[1].abs() < w)
    t = torch.where(ok, t, inf)
    better = t < out_t
    out_t = torch.where(better, t, out_t)
    out_l = torch.where(better, torch.full_like(out_l, SEG["sidewalk"]), out_l)
    return out_t, out_l


def scene_tensors(scene: Dict, device, t: float = 0.0) -> Dict[str, torch.Tensor]:
    """The boxes as float64 tensors on `device`, moved to time `t` (s) by
    their velocities."""
    bx = scene["boxes"]
    center = bx["center"].copy()
    center[:, :2] += bx["vel"] * t
    return {"center": torch.as_tensor(center, device=device),
            "half": torch.as_tensor(bx["half"], device=device),
            "yaw": torch.as_tensor(bx["yaw"], device=device),
            "seg": torch.as_tensor(bx["seg"], device=device),
            "kind": torch.as_tensor(bx["kind"], device=device)}


def cast(scene: Dict, origin, dirs_road: torch.Tensor, sensor: Dict,
         gen: torch.Generator, t: float = 0.0):
    """Cast rays (road frame directions) from `origin` (road frame, meters)
    at time `t`: (hits (M, 3) road frame, labels (M,), reflectance (M,)),
    the rays without a return within `max_range_m` or dropped left out."""
    dev = dirs_road.device
    o = torch.as_tensor(origin, dtype=torch.float64, device=dev)
    bx = scene_tensors(scene, dev, t)
    tb, ib = _box_hits(o, dirs_road, bx)
    tg, lg = _ground_hits(o, dirs_road, scene)
    use_box = tb < tg
    tt = torch.where(use_box, tb, tg)
    safe = ib.clamp(min=0)
    lab = torch.where(use_box, bx["seg"][safe], lg)
    veg = use_box & (bx["kind"][safe] == VEGETATION)
    n = tt.shape[0]
    u = torch.rand((3, n), generator=gen, device=dev, dtype=torch.float64)
    nz = torch.randn((2, n), generator=gen, device=dev, dtype=torch.float64)
    # leaves: returns scatter into the band's depth
    tt = tt + torch.where(veg, u[0] * sensor["vegetation_depth_m"],
                          torch.zeros_like(tt))
    tt = tt + nz[0] * sensor["range_noise_m"]
    keep = (torch.isfinite(tt) & (tt < sensor["max_range_m"])
            & (tt > sensor["min_range_m"]) & (u[1] >= sensor["drop_share"]))
    refl = torch.tensor([REFLECTANCE.get(i, 0.2) for i in range(20)],
                        dtype=torch.float64, device=dev)[lab]
    refl = (refl + 0.08 * nz[1]).clamp(0.0, 1.0)
    hits = o[None] + tt[:, None] * dirs_road
    return hits[keep], lab[keep], refl[keep]


def _rot_z(v: torch.Tensor, yaw: float) -> torch.Tensor:
    c, s = math.cos(yaw), math.sin(yaw)
    x, y = v[:, 0], v[:, 1]
    return torch.stack([c * x - s * y, s * x + c * y, v[:, 2]], -1)


def kitti_scan(seed_seq, traffic: Dict, device) -> Dict[str, np.ndarray]:
    """One SemanticKITTI-like scan: points (N, 4) float32 (x, y, z,
    reflectance) in the sensor frame and their surface labels (N,) int64."""
    rng = np.random.default_rng(seed_seq)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63 - 1)))
    scene = make_scene(rng, traffic["scene"])
    sensor = traffic["sensor"]
    d = _rot_z(beam_directions(sensor, gen, device), scene["yaw"])
    hits, lab, refl = cast(scene, (0.0, 0.0, 0.0), d, sensor, gen)
    pts = _rot_z(hits, -scene["yaw"])
    points = torch.cat([pts, refl[:, None]], 1).to(torch.float32)
    return {"points": points.cpu().numpy(), "labels": lab.cpu().numpy()}


def nusc_frame(seed_seq, traffic: Dict, device) -> Dict[str, np.ndarray]:
    """One nuScenes-like 10-sweep frame: points (N, 5) float32 (x, y, z,
    intensity 0-255, time lag s) in the keyframe's sensor frame, the ego
    moving along the road between sweeps, and the keyframe's boxes of the
    ten classes as ground truth (x, y, z, w, l, h, vx, vy, yaw)."""
    rng = np.random.default_rng(seed_seq)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63 - 1)))
    scene = make_scene(rng, traffic["scene"])
    sensor = traffic["sensor"]
    speed = rng.uniform(*traffic["ego_speed_mps"])
    lane = traffic["scene"].get("ego_lane_y_m", 0.0)
    parts = []
    for k in range(traffic["sweeps"]):
        t = -k * traffic["sweep_period_s"]
        origin = (speed * t, lane, 0.0)
        d = _rot_z(beam_directions(sensor, gen, device), scene["yaw"])
        hits, _, refl = cast(scene, origin, d, sensor, gen, t)
        rel = hits - torch.tensor([0.0, lane, 0.0], dtype=hits.dtype,
                                  device=hits.device)
        pts = _rot_z(rel, -scene["yaw"])
        lag = torch.full_like(refl, -t)
        parts.append(torch.cat([pts, (refl * 255.0)[:, None], lag[:, None]],
                               1))
    points = torch.cat(parts).to(torch.float32).cpu().numpy()
    bx = scene["boxes"]
    det = bx["det"] >= 0
    c = bx["center"][det].copy()
    c[:, 1] -= lane
    cy, sy = math.cos(-scene["yaw"]), math.sin(-scene["yaw"])
    xy = np.stack([cy * c[:, 0] - sy * c[:, 1], sy * c[:, 0] + cy * c[:, 1]],
                  1)
    v = bx["vel"][det]
    vxy = np.stack([cy * v[:, 0] - sy * v[:, 1], sy * v[:, 0] + cy * v[:, 1]],
                   1)
    half = bx["half"][det]
    gt = np.concatenate([xy, c[:, 2:3], 2 * half[:, 1:2], 2 * half[:, 0:1],
                         2 * half[:, 2:3], vxy,
                         (bx["yaw"][det] - scene["yaw"])[:, None]], 1)
    return {"points": points, "gt_boxes": gt.astype(np.float32),
            "gt_classes": bx["det"][det]}


def item_seed(seed: int, index: int) -> np.random.SeedSequence:
    """The seed of pool item `index` of a run seeded `seed` (any whole
    number >= 0, also beyond 64 bits)."""
    return np.random.SeedSequence([int(seed) % 2**64, int(seed) // 2**64,
                                   int(index)])

