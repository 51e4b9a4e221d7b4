#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`link_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, one card

Phases, in order (any failure raises and the script exits non-zero):
  1. build       compile every CUDA kernel from `link_tpu_torch/csrc/` with
                 nvcc (sm_90a), all sources at once, and print the card's
                 name and power limit;
  2. kernels     hold each kernel against its plain PyTorch twin at the seg
                 path's shapes (84,992-row tables from a synthetic 80k-voxel
                 scan), and time kernel, twin and the library yardstick;
  3. golden      ELKUNet cr1.0 float32 (TF32 off) at DEFAULT_CAPACITIES on
                 the real 80k-voxel scan of
                 tests/goldens/elkunet_cr1.0_fullscale.npz with the
                 reference weights, against the reference logits;
  4. main        the seg path: bfloat16 ELKUNet cr1.0 with seeded random
                 weights on 4 synthetic 80k-voxel scans, with the launch
                 counts of the kernels read around one pass, and scans/s;
  5. profile     one more pass of the seg path under torch.profiler: device
                 time by kernel, and the device's idle share against the
                 unprofiled wall time of phase 4;
  6. det_kernels `window_conv` and both modes of `sorted_join` against
                 their twins at the det path's shapes (163,840-row level 0
                 and 81,920-row level 1 of one synthetic 160k-voxel
                 nuScenes frame), timed with twin and library yardstick;
  7. det_golden  the RPN + CenterHead in float32 (TF32 off) with the
                 reference weights of tests/goldens/det_dense.npz against its
                 RPN output and head maps;
  8. det_main    the det serving path: SingleFramePredictor, bfloat16
                 CenterPoint-ELKv3 with seeded random weights at the 160k
                 val capacity, on 2 synthetic frames: launch counts of the
                 kernels around one pass, frames/s of forward + decode, ms per
                 end-to-end `predict` (host voxelize and NMS included), boxes;
  9. det_profile one det forward + decode per frame under torch.profiler:
                 device time by kernel and the device's idle share;
 10. train_kernels `gather_wgrad` against its twin, and the conv's whole
                 backward (`GatherConv`: feature gradient through
                 `gather_conv` over the inverse map, weight gradient through
                 `gather_wgrad`) against PyTorch autograd through the plain
                 conv, at the training path's shapes (level 0 of one
                 synthetic batch of two scans: 169,984 rows, K=27 and the
                 K=8 down conv with its inverse), float32 and bfloat16;
 11. train_grad  one train step of the tiny ELKUNet of
                 tests/goldens/train_ab.npz on its scan 0, once on the CPU
                 (plain twins) and once on the card (kernels): loss and
                 every parameter's gradient;
 12. train_golden the 40 SGD steps of train_ab.npz replayed on the card
                 (PyTorch's deterministic algorithms on, so that every run
                 gives the same curve) against the reference's loss curve;
 13. train_main  the seg training path: ELKUNet cr1.0 float32, batch 2 at
                 2 x DEFAULT_CAPACITIES, the recipe of
                 configs/semantic_kitti/linkunet/default.yaml (SGD nesterov,
                 lr 0.24 under cosine_warmup), 1 warm and 6 timed steps on
                 synthetic scans: loss per step, ms per step, training
                 scans/s, launches of each kernel around one step, peak
                 memory;
 14. train_profile one more step under torch.profiler: device time by kernel,
                 idle share, and the forward / backward / optimizer split;
 15. probes      every case of `link_tpu_torch.tools.probe_gather` (the
                 Mosaic probes' shapes and the port's own), each exact
                 against its twin, timed beside its bound and the library
                 gather.

Output: `#`-prefixed progress lines, then a line with the card's name and
power limit (nvidia-smi), then one JSON line {"kernels": [...]} with each
kernel's launches on the main path, error against its twin, times and bound,
and last {"ok": true, "device": {...}}. Details also go to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device or when
the `link_tpu_torch` package is not beside this file.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "goldens", "elkunet_cr1.0_fullscale.npz")
DET_GOLDEN = os.path.join(HERE, "tests", "goldens", "det_dense.npz")
TRAIN_GOLDEN = os.path.join(HERE, "tests", "goldens", "train_ab.npz")
TRAIN_GOLDEN_CAPS = (1024, 640, 256, 128, 64)
SEG_CONFIG = os.path.join(HERE, "configs", "semantic_kitti", "linkunet",
                          "default.yaml")
OUT_JSON = os.path.join(HERE, "chiprun_out", "chip_smoke.json")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and per-type rates.
# int32 on the CUDA cores runs at half the float32 rate (64 INT32 lanes vs
# 128 FP32 lanes per SM).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int32": 33.5e12}

F32_REL_TOL = 1e-5    # kernel vs twin, f32: only the summation order differs
BF16_REL_TOL = 8e-3   # kernel vs twin, bf16: both round the f32 sum once to
#                       bf16 (half-ulp 2^-9); a different summation order can
#                       move a value across a rounding boundary: one ulp 2^-8
GOLDEN_REL_TOL = 2e-4  # as the JAX package's golden parity tests
DET_GOLDEN_REL_TOL = 1e-5  # as tests/test_golden_det_dense.py
TRAIN_GRAD_REL_TOL = 1e-4  # card vs CPU, each gradient against its largest
#                            magnitude: float32 on both, ~60 layers of sums in
#                            another order; `gather_wgrad` sums its partials
#                            in a fixed order (no atomics), so nothing varies
#                            from run to run


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def rel_err(got, want) -> float:
    got = got.float()
    want = want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` back-to-back calls (warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def phase_build(res, ctx):
    from link_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    logs = kernels.build_kernels()
    res["build_s"] = time.perf_counter() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"{src}: {line.strip()}")
    log(f"build: {res['build_s']:.1f} s ({len(logs)} sources compiled)")


def _scan_tensor(index: int, device):
    from link_tpu_torch.data.collate import collate_scans, to_sparse_tensor
    from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI, grid_extent
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    ds = SyntheticSemanticKITTI(length=index + 1, num_points=80000,
                                n_raw_points=120000, split="train")
    ext = grid_extent(0.05, batch_size=1)
    batch = collate_scans([ds[index]], DEFAULT_CAPACITIES[0], grid_extent=ext)
    return to_sparse_tensor(batch, device=device, grid_extent=ext)


def _conv_case(kernels, feats, idx, weight, iters):
    """Kernel vs twin on one conv shape: error, times, bound."""
    import torch
    got = kernels.gather_conv(feats, idx, weight)
    want = kernels.gather_conv_plain(feats, idx, weight)
    torch.cuda.synchronize()
    dt = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    err = rel_err(got, want)
    tol = BF16_REL_TOL if dt == "bfloat16" else F32_REL_TOL
    n, ci = feats.shape
    k, m = idx.shape
    co = weight.shape[2]
    isz = feats.element_size()
    hits = int((idx >= 0).sum())
    nbytes = n * ci * isz + k * m * 4 + k * ci * co * isz + m * co * isz
    ops = 2.0 * hits * ci * co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    case = {
        "shape": f"N={n} M={m} K={k} Ci={ci} Co={co} {dt}",
        "rel_err": err, "tol": tol,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": cuda_ms(lambda: kernels.gather_conv(feats, idx, weight), iters),
        "plain_ms": cuda_ms(
            lambda: kernels.gather_conv_plain(feats, idx, weight), iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "hits": hits,
    }
    log(f"gather_conv {case['shape']}: rel err {err:.3g} (tol {tol}), "
        f"kernel {case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
        f"hits {hits}")
    if not err < tol:
        raise AssertionError(f"gather_conv {case['shape']}: rel err {err} "
                             f">= {tol}")
    return case


def _join_case(kernels, C, table, coords, offsets, mode, iters):
    """sorted_join vs its twin in one mode, on the queries coords + each
    offset: exact agreement, times, bound, and the library call
    (`torch.searchsorted`, plus the hit test in mode "exact")."""
    import torch
    offs = torch.tensor(np.asarray(offsets), dtype=torch.int32,
                        device=coords.device)
    q = torch.cat([coords[None, :, :3] + offs[:, None, :],
                   coords[None, :, 3:].expand(len(offs), -1, -1)], -1)
    q_hi, q_lo = C.pack_coords(q.reshape(-1, 4))
    args = (table.hi, table.lo, table.perm, q_hi, q_lo)
    got = kernels.sorted_join(*args, mode=mode)
    want = kernels.sorted_join_plain(*args, mode=mode)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"sorted_join {mode}: {mismatches} of "
                             f"{got.numel()} results differ from the twin")
    n, nq = table.hi.numel(), q_hi.numel()
    tkey = kernels.key64(table.hi, table.lo)
    qkey = kernels.key64(q_hi, q_lo)

    def library():
        pos = torch.searchsorted(tkey, qkey).clamp_(max=n - 1)
        if mode == "lower_bound":
            return pos
        hit = (tkey[pos] == qkey) & (q_hi != C.INT32_MAX)
        return torch.where(hit, table.perm[pos], -1)

    # table keys (and perm in mode exact) read once, queries read, results
    # written; ~3 int32 operations per search probe
    probes = math.ceil(math.log2(n + 1))
    t_bytes = ((3 if mode == "exact" else 2) * n * 4
               + 3 * nq * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 3.0 * nq * probes / PEAK_OPS["int32"] * 1e3
    case = {
        "shape": f"N={n} Q={nq} int32 {mode}",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: kernels.sorted_join(*args, mode=mode), iters),
        "plain_ms": cuda_ms(lambda: kernels.sorted_join_plain(
            *args, mode=mode), iters),
        "library_ms": cuda_ms(library, iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"sorted_join {case['shape']}: equal to the twin, kernel "
        f"{case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, searchsorted "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})")
    return case


def phase_kernels(res, ctx, iters=20):
    import torch
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse import coords as C
    from link_tpu_torch.sparse.conv import build_conv_plan, invert_plan
    from link_tpu_torch.sparse.ops import spdownsample
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES

    dev = torch.device("cuda")
    st = _scan_tensor(0, dev)
    n = st.capacity
    log(f"kernel inputs: scan 0, {int(st.nnz)} voxels in {n} rows")

    # --- sorted_join, exact mode: 84,992-row table, 27 x 84,992 queries,
    # the one join of the stem's submanifold plan
    table = C.build_table(st.coords, assume_sorted=True)
    res["sorted_join"] = _join_case(kernels, C, table, st.coords,
                                    C.kernel_offsets_np(3), "exact", iters)

    # --- gather_conv at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(0)
    in_idx = build_conv_plan(st.coords, st.coords, st.nnz,
                             C.kernel_offsets_np(3), n, in_sorted=True,
                             table=table).in_idx
    down_coords, down_nnz = spdownsample(st.coords, DEFAULT_CAPACITIES[1])
    down = build_conv_plan(st.coords, down_coords, down_nnz,
                           C.kernel_offsets_np(2), n, in_sorted=True,
                           table=table)
    inv_idx = invert_plan(down)                            # (8, 84992)
    m_coarse = down_coords.shape[0]

    def rand(shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev)
        return x.to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        f64 = rand((n, 64), dtype)
        cases.append(_conv_case(kernels, f64, in_idx,
                                rand((27, 64, 64), dtype) * 0.125, iters))
        cases.append(_conv_case(kernels, st.feats.to(dtype), in_idx,
                                rand((27, 4, 64), dtype) * 0.1, iters))
        cases.append(_conv_case(kernels, rand((n, 128), dtype), in_idx,
                                rand((27, 128, 64), dtype) * 0.09, iters))
        cases.append(_conv_case(kernels, rand((m_coarse, 64), dtype), inv_idx,
                                rand((8, 64, 64), dtype) * 0.125, iters))
    res["gather_conv_cases"] = cases


def _golden_state(g):
    import torch
    return {k[len("state/"):]: torch.from_numpy(np.array(g[k]))
            for k in g.files if k.startswith("state/")}


def phase_golden(res, ctx):
    import torch
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES, ELKUNet
    from link_tpu_torch.sparse.coords import INVALID_COORD
    from link_tpu_torch.sparse.tensor import make_sparse_tensor

    g = np.load(GOLDEN)
    model = ELKUNet(num_classes=20, cr=float(g["cr"]),
                    capacities=DEFAULT_CAPACITIES, dtype="float32",
                    device="cuda")
    model.load_state_dict(_golden_state(g), strict=True)
    model.eval()
    coords, feats, want = g["coords"], g["feats"], g["logits"]
    n, cap = len(coords), DEFAULT_CAPACITIES[0]
    cpad = np.full((cap, 4), INVALID_COORD, np.int32)
    fpad = np.zeros((cap, feats.shape[1]), np.float32)
    cpad[:n], fpad[:n] = coords, feats
    st = make_sparse_tensor(fpad, cpad, nnz=n, device="cuda")
    with torch.inference_mode():
        got = model(st)
        res["golden_ms"] = cuda_ms(lambda: model(st.replace(
            cmaps={st.stride: (st.coords, st.nnz)}, kmaps={})), 3)
    torch.cuda.synchronize()
    got = got[:n].float().cpu().numpy()
    err = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))
    res["golden_rel_err"] = err
    log(f"golden cr1.0 f32 ({n} voxels): rel err {err:.3g} "
        f"(tol {GOLDEN_REL_TOL}); forward {res['golden_ms']:.2f} ms")
    if not np.isfinite(got).all() or not err < GOLDEN_REL_TOL:
        raise AssertionError(f"full-scale golden: rel err {err}")


def phase_main(res, ctx, n_scans=4, rounds=3):
    import torch
    from link_tpu_torch.data.semantic_kitti import NUM_CLASSES, grid_extent
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES, ELKUNet
    from link_tpu_torch.nn.modules import SparseConv3d
    from link_tpu_torch.ops import kernels

    ext = grid_extent(0.05, batch_size=1)
    scans = [_scan_tensor(i, "cuda") for i in range(n_scans)]
    model = ELKUNet(num_classes=NUM_CLASSES, cr=1.0,
                    capacities=DEFAULT_CAPACITIES, dtype="bfloat16",
                    grid_extent=ext, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    model.eval()

    def fresh(st):
        # a new tensor per pass, so every pass builds its own plans
        return st.replace(cmaps={st.stride: (st.coords, st.nnz)}, kmaps={})

    with torch.inference_mode():
        model(fresh(scans[0]))                                 # warm-up
        torch.cuda.synchronize()

        kernels.reset_launch_counts()
        inputs = [fresh(st) for st in scans]
        outs = [model(x) for x in inputs]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}

        times = []
        for _ in range(rounds):
            inputs = [fresh(st) for st in scans]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in inputs:
                model(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)

    for st, out in zip(scans, outs):
        n = int(st.nnz)
        if out.shape != (st.capacity, NUM_CLASSES):
            raise AssertionError(f"logits shape {tuple(out.shape)}")
        if not torch.isfinite(out[:n].float()).all():
            raise AssertionError("non-finite logits on the main path")

    plans = sum(1 for k in inputs[0].kmaps if k[0] == "plan")
    n_elk = 4
    want_join = n_scans * (plans + n_elk)
    want_conv = n_scans * sum(
        1 for mod in model.modules()
        if isinstance(mod, SparseConv3d) and math.prod(mod.kernel_size) > 1)
    res["launches"] = launches
    res["scans_per_s"] = [n_scans / t for t in times]
    log(f"main path bf16, {n_scans} scans: launches {launches} (expected "
        f"sorted_join {want_join}, gather_conv {want_conv}); scans/s per "
        f"round {[round(v, 3) for v in res['scans_per_s']]}")
    if launches["sorted_join"] != want_join or launches["gather_conv"] != want_conv:
        raise AssertionError(f"launch counts {launches} differ from the "
                             f"expected {want_join} joins, {want_conv} convs")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    ctx.update(model=model, scans=scans, fresh=fresh)


def _profile(run, n_items: int, wall_ms: float, unit: str, ranges=()):
    """Device time by kernel over `run()` under torch.profiler, per item,
    and the idle share against the unprofiled wall time per item. `ranges`
    names `record_function` ranges inside `run`; each is reported with its
    host time and the device time of the kernels launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n_items
    by_name = sorted(((e.self_device_time_total / 1e3 / n_items, e.count
                       // n_items, e.key) for e in kern), reverse=True)
    out = {
        f"device_busy_ms_per_{unit}": busy_ms or None,
        f"wall_ms_per_{unit}": wall_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        f"launches_per_{unit}": sum(e.count for e in kern) / n_items,
        "kernel_kinds": len(kern),
        "kernels": [{f"ms_per_{unit}": t, f"launches_per_{unit}": c,
                     "name": k[:160]} for t, c, k in by_name[:25]],
    }
    if not busy_ms:
        log("profile: no device time in the trace (not measured)")
        return out
    for name in ranges:
        host = [e for e in events if e.key == name
                and e.device_type == DeviceType.CPU]
        out.setdefault("ranges", {})[name] = {
            "host_ms": sum(e.cpu_time_total for e in host) / 1e3 / n_items,
            "device_ms": sum(e.device_time_total for e in host) / 1e3
            / n_items or None}
    log(f"profile: device busy {busy_ms:.2f} ms per {unit} of {wall_ms:.2f} "
        f"ms wall (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{out[f'launches_per_{unit}']:.0f} kernel launches per {unit} "
        f"of {len(kern)} kinds")
    for t, c, k in by_name[:12]:
        log(f"  {t:8.3f} ms {t / busy_ms:6.1%} x{c:<5d} {k[:90]}")
    for name, r in out.get("ranges", {}).items():
        dev = (f"{r['device_ms']:.2f} ms" if r["device_ms"]
               else "not measured")
        log(f"  range {name}: host {r['host_ms']:.2f} ms, device {dev}")
    return out


def phase_profile(res, ctx):
    """Device time by kernel over one pass of the seg path's scans."""
    import torch
    model, scans, fresh = ctx["model"], ctx["scans"], ctx["fresh"]
    with torch.inference_mode():
        inputs = [fresh(st) for st in scans]
        res["profile"] = _profile(lambda: [model(x) for x in inputs],
                                  len(scans), 1e3 / max(res["scans_per_s"]),
                                  "scan")


# --------------------------------------------------------------------------
# detection serving path


def _det_frame(index: int):
    """One synthetic nuScenes frame: raw points and the collated batch at
    the 160k val cap (capacity 163,840), as SingleFramePredictor makes it."""
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.data.nuscenes import SyntheticNuScenes
    from link_tpu_torch.models.scn import DET_CAPACITIES
    ds = SyntheticNuScenes(length=index + 1, mode="val", seed=0,
                           max_voxels=160000)
    return ds.points(index), dp.collate_det([ds[index]], DET_CAPACITIES[0])


def _window_case(kernels, feats, plan, weight, iters):
    """window_conv vs its twin on one plan: error, times, bound."""
    import torch
    args = (feats, plan.base_pos, plan.slot, plan.groups, weight)
    got = kernels.window_conv(*args)
    want = kernels.window_conv_plain(*args)
    torch.cuda.synchronize()
    dt = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    err = rel_err(got, want)
    tol = BF16_REL_TOL if dt == "bfloat16" else F32_REL_TOL
    n, ci = feats.shape
    k, m = plan.slot.shape
    gg = plan.base_pos.shape[0]
    co = weight.shape[2]
    isz = feats.element_size()
    hits = int((plan.slot >= 0).sum())
    nbytes = (n * ci * isz + gg * m * 4 + k * m + k * ci * co * isz
              + m * co * isz)
    ops = 2.0 * hits * ci * co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    case = {
        "shape": f"N=M={m} G={plan.window} K={k} Ci={ci} Co={co} {dt}",
        "rel_err": err, "tol": tol,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": cuda_ms(lambda: kernels.window_conv(*args), iters),
        "plain_ms": cuda_ms(lambda: kernels.window_conv_plain(*args), iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "hits": hits,
    }
    log(f"window_conv {case['shape']}: rel err {err:.3g} (tol {tol}), "
        f"kernel {case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), hits {hits}")
    if not err < tol:
        raise AssertionError(f"window_conv {case['shape']}: rel err {err} "
                             f">= {tol}")
    return case


def phase_det_kernels(res, ctx, iters=20):
    import torch
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse import coords as C
    from link_tpu_torch.sparse.conv import add_window_form, build_conv_plan
    from link_tpu_torch.sparse.spconv_engine import (spconv_downsample,
                                                     spconv_out_shape)
    from link_tpu_torch.models.scn import DET_CAPACITIES

    dev = torch.device("cuda")
    _, batch = _det_frame(0)
    coords = torch.from_numpy(batch["coords"]).to(dev)
    nnz = torch.tensor(int(batch["nnz"]), dtype=torch.int32, device=dev)
    n = coords.shape[0]
    log(f"det kernel inputs: frame 0, {int(batch['nnz'])} voxels in {n} rows")
    offs = C.kernel_offsets_np(3)

    # --- sorted_join on the 163,840-row level-0 table: exact mode, the
    # SubM plan's 27 taps per row; lower-bound mode, its window form's 9
    # group anchors per row
    table = C.build_table(coords, assume_sorted=True)
    res["sorted_join_det_exact"] = _join_case(kernels, C, table, coords,
                                              offs, "exact", iters)
    res["sorted_join_lower_bound"] = _join_case(
        kernels, C, table, coords, [a for a, _ in C.offset_groups(offs)],
        "lower_bound", iters)

    # --- window_conv on the level-0 and level-1 SubM plans
    plan0 = add_window_form(build_conv_plan(coords, coords, nnz, offs, n,
                                            in_sorted=True, table=table),
                            table, offs, 1)
    shape1 = spconv_out_shape((1440, 1440, 41), (3, 3, 3), (2, 2, 2),
                              (1, 1, 1))
    c1, nnz1 = spconv_downsample(coords, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                 shape1, DET_CAPACITIES[1])
    table1 = C.build_table(c1, assume_sorted=True)
    plan1 = add_window_form(build_conv_plan(c1, c1, nnz1, offs, c1.shape[0],
                                            in_sorted=True, table=table1),
                            table1, offs, 1)
    log(f"det level 1: {int(nnz1)} voxels in {c1.shape[0]} rows")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for plan, ci, co in ((plan0, 16, 16), (plan0, 5, 16),
                             (plan1, 32, 32)):
            m = plan.slot.shape[1]
            cases.append(_window_case(
                kernels, rand((m, ci), dtype), plan,
                rand((27, ci, co), dtype, (ci * 27) ** -0.5), iters))
    res["window_conv_cases"] = cases


def phase_det_golden(res, ctx):
    import torch
    from link_tpu_torch.models.center_head import CenterHead
    from link_tpu_torch.models.rpn import RPN

    g = np.load(DET_GOLDEN)
    sd = {k[3:].replace("__", "."): torch.from_numpy(np.array(g[k]))
          for k in g.files if k.startswith("sd_")}
    neck = RPN(device="cuda")
    neck.load_state_dict({k[5:]: v for k, v in sd.items()
                          if k.startswith("neck.")}, strict=True)
    head = CenterHead(device="cuda")
    head.load_state_dict({k[10:]: v for k, v in sd.items()
                          if k.startswith("bbox_head.")}, strict=True)
    neck.eval()
    head.eval()
    with torch.inference_mode():
        rpn_out = neck(torch.from_numpy(g["bev"]).cuda())
        preds = head(torch.from_numpy(g["rpn_out"]).cuda())
    errs = {"rpn_out": rel_err(rpn_out, torch.from_numpy(g["rpn_out"]).cuda())}
    for t, pd in enumerate(preds):
        for name, v in pd.items():
            want = torch.from_numpy(g[f"task{t}_{name}"]).cuda()
            errs[f"task{t}_{name}"] = rel_err(v.permute(0, 3, 1, 2), want)
    worst = max(errs, key=errs.get)
    res["det_golden_rel_err"] = errs
    log(f"det golden RPN + CenterHead f32: {len(errs)} maps, worst rel err "
        f"{errs[worst]:.3g} ({worst}; tol {DET_GOLDEN_REL_TOL})")
    if not all(v < DET_GOLDEN_REL_TOL for v in errs.values()):
        raise AssertionError(f"det golden: {worst} rel err {errs[worst]}")


def phase_det_main(res, ctx, n_frames=2, rounds=3):
    import torch
    from link_tpu_torch.inference import SingleFramePredictor
    from link_tpu_torch.models.scn import SubMConv3d
    from link_tpu_torch.nn.modules import SparseConv3d
    from link_tpu_torch.ops import kernels

    frames = [_det_frame(i) for i in range(n_frames)]
    pred = SingleFramePredictor(dtype="bfloat16", seed=0, device="cuda")
    batches = [b for _, b in frames]
    pred.forward(batches[0])                                  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outs = [pred.forward(b) for b in batches]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            pred.forward(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    predict_ms, kept = [], []
    for points, _ in frames:
        t0 = time.perf_counter()
        det = pred.predict(points)
        predict_ms.append((time.perf_counter() - t0) * 1e3)
        kept.append(len(det["scores"]))
        if not (np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError("non-finite boxes from predict")

    for out in outs:
        for boxes, scores, labels, mask in out:
            if boxes.shape != (1, 180 * 180, 9):
                raise AssertionError(f"boxes shape {tuple(boxes.shape)}")
            if not torch.isfinite(boxes[mask]).all():
                raise AssertionError("non-finite boxes on the det path")
    convs = sum(1 for mod in pred.model.modules()
                if isinstance(mod, SubMConv3d)
                or (isinstance(mod, SparseConv3d)
                    and math.prod(mod.kernel_size) > 1)) + 4  # 3 downs + extra
    # 4 SubM levels (exact join + the window form's lower bound each),
    # 3 downs and the extra conv (exact join each)
    plans = 4 * 2 + 4
    per_frame = {k: v / n_frames for k, v in launches.items()}
    res["det_launches"] = launches
    res["det_frames_per_s"] = [n_frames / t for t in times]
    res["det_predict_ms"] = predict_ms
    res["det_boxes_kept"] = kept
    res["det_nnz"] = [int(b["nnz"]) for b in batches]
    log(f"det path bf16, {n_frames} frames ({res['det_nnz']} voxels): "
        f"launches per frame {per_frame} (expected sorted_join {plans}, "
        f"window_conv + gather_conv {convs}); forward + decode frames/s per "
        f"round {[round(v, 3) for v in res['det_frames_per_s']]}; predict "
        f"ms per frame {[round(v, 1) for v in predict_ms]}; boxes kept {kept}")
    if (launches["sorted_join"] != n_frames * plans
            or launches["window_conv"] + launches["gather_conv"]
            != n_frames * convs
            or min(launches[k] for k in ("sorted_join", "window_conv",
                                         "gather_conv")) == 0):
        raise AssertionError(f"det launch counts {launches} differ from the "
                             f"expected {plans} joins and {convs} convs per "
                             "frame, or a kernel was not launched")
    res["det_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    ctx.update(pred=pred, det_batches=batches)


def phase_det_profile(res, ctx):
    pred, batches = ctx["pred"], ctx["det_batches"]
    res["det_profile"] = _profile(
        lambda: [pred.forward(b) for b in batches], len(batches),
        1e3 / max(res["det_frames_per_s"]), "frame")


# --------------------------------------------------------------------------
# seg training path


def _train_batches(n_batches: int, caps0: int, ext):
    """`n_batches` collated batches of two synthetic 80k-voxel scans each,
    augmented from per-step generators as the training loop seeds them."""
    from link_tpu_torch.data.collate import collate_scans
    from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
    ds = SyntheticSemanticKITTI(length=2 * n_batches, num_points=80000,
                                n_raw_points=120000, split="train")
    out = []
    for step in range(n_batches):
        rng = np.random.default_rng(100 + step)
        out.append(collate_scans(
            [ds.__getitem__(2 * step + k, rng) for k in range(2)], caps0,
            grid_extent=ext))
    return out


def _wgrad_case(kernels, feats, g, bwd_idx, iters):
    """gather_wgrad vs its twin on one shape: error, times, bound."""
    import torch
    got = kernels.gather_wgrad(feats, g, bwd_idx)
    want = kernels.gather_wgrad_plain(feats, g, bwd_idx)
    again = kernels.gather_wgrad(feats, g, bwd_idx)
    torch.cuda.synchronize()
    dt = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    err = rel_err(got, want)
    n, ci = feats.shape
    m, co = g.shape
    k = bwd_idx.shape[0]
    isz = feats.element_size()
    hits = int((bwd_idx >= 0).sum())
    # feats, g and the index read once, dW written once; the products of
    # the hit (tap, row) slots on the float32 CUDA cores (bfloat16 inputs
    # are widened, the kernel uses no tensor cores)
    nbytes = n * ci * isz + m * co * isz + k * n * 4 + k * ci * co * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * hits * ci * co / PEAK_OPS["float32"] * 1e3
    case = {
        "shape": f"N={n} M={m} K={k} Ci={ci} Co={co} {dt}",
        "rel_err": err, "tol": F32_REL_TOL,
        "max_abs_err": float((got - want).abs().max()),
        "same_twice": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: kernels.gather_wgrad(feats, g, bwd_idx), iters),
        "plain_ms": cuda_ms(
            lambda: kernels.gather_wgrad_plain(feats, g, bwd_idx), iters),
        "bound_ms": max(t_bytes, t_ops), "bound_bytes_ms": t_bytes,
        "bound_ops_ms": t_ops,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "hits": hits,
    }
    log(f"gather_wgrad {case['shape']}: rel err {err:.3g} (tol "
        f"{F32_REL_TOL}), kernel {case['ms']:.4f} ms, twin "
        f"{case['plain_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}; bytes {t_bytes:.4f}, operations {t_ops:.4f}), "
        f"hits {hits} of {k * n}")
    # float32 result from exact products, so one bound for both dtypes
    if not err < F32_REL_TOL:
        raise AssertionError(f"gather_wgrad {case['shape']}: rel err {err} "
                             f">= {F32_REL_TOL}")
    if not case["same_twice"]:
        raise AssertionError(f"gather_wgrad {case['shape']}: two runs differ")
    return case


def _function_case(kernels, GatherConv, feats, weight, idx, bwd_idx):
    """The conv's whole backward through the kernels against PyTorch
    autograd through the plain conv, on the card."""
    import torch
    gen = torch.Generator(device=feats.device).manual_seed(1)
    cot = torch.randn((idx.shape[1], weight.shape[2]), generator=gen,
                      device=feats.device).to(feats.dtype)
    grads = []
    for fn in (lambda f, w: GatherConv.apply(f, w, idx, bwd_idx),
               lambda f, w: kernels.gather_conv_plain(f, idx, w)):
        f = feats.clone().requires_grad_()
        w = weight.clone().requires_grad_()
        fn(f, w).backward(cot)
        grads.append((f.grad, w.grad))
    torch.cuda.synchronize()
    bf16 = feats.dtype == torch.bfloat16
    # bfloat16: autograd of the plain conv rounds its weight gradient to
    # bfloat16 on the way back through the weight's cast, the Function
    # keeps float32, so both gradients are held to one bfloat16 ulp
    tol = BF16_REL_TOL if bf16 else F32_REL_TOL
    errs = {"d_feats": rel_err(grads[0][0], grads[1][0]),
            "d_weight": rel_err(grads[0][1], grads[1][1])}
    shape = (f"N={feats.shape[0]} M={idx.shape[1]} K={idx.shape[0]} "
             f"Ci={feats.shape[1]} Co={weight.shape[2]} "
             f"{'bfloat16' if bf16 else 'float32'}")
    log(f"GatherConv backward {shape}: d_feats rel err "
        f"{errs['d_feats']:.3g}, d_weight rel err {errs['d_weight']:.3g} "
        f"(tol {tol})")
    if not max(errs.values()) < tol:
        raise AssertionError(f"GatherConv backward {shape}: {errs}")
    return {"shape": shape, "tol": tol, **errs}


def phase_train_kernels(res, ctx, iters=10):
    import torch
    from link_tpu_torch.data.collate import to_sparse_tensor
    from link_tpu_torch.data.semantic_kitti import grid_extent
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse import coords as C
    from link_tpu_torch.sparse.conv import (GatherConv, build_conv_plan,
                                            invert_plan, plan_bwd_idx)
    from link_tpu_torch.sparse.ops import spdownsample

    dev = torch.device("cuda")
    ext = grid_extent(0.05, batch_size=2)
    caps = tuple(2 * c for c in DEFAULT_CAPACITIES)
    batches = _train_batches(4, caps[0], ext)
    ctx.update(train_batches=batches, train_caps=caps, train_ext=ext)
    st = to_sparse_tensor(batches[0], device=dev, grid_extent=ext)
    n = st.capacity
    log(f"train kernel inputs: batch 0, {int(st.nnz)} voxels in {n} rows")

    table = C.build_table(st.coords, assume_sorted=True)
    subm = build_conv_plan(st.coords, st.coords, st.nnz,
                           C.kernel_offsets_np(3), n, in_sorted=True,
                           table=table)
    down_coords, down_nnz = spdownsample(st.coords, caps[1])
    down = build_conv_plan(st.coords, down_coords, down_nnz,
                           C.kernel_offsets_np(2), n, in_sorted=True,
                           table=table)
    down = down.replace(inv_idx=invert_plan(down))
    m_down = down_coords.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    wgrad, function = [], []
    for dtype in (torch.float32, torch.bfloat16):
        # (feats rows, Ci, out rows, Co, forward map, inverse map):
        # submanifold 64 -> 64, the stem 4 -> 64, the decoder's first conv
        # after the skip concat 128 -> 64 (two Ci tiles of the weight
        # gradient, Co = 128 in the feature gradient), the K=8 down conv
        # and the transposed conv over its inverse
        for rows, ci, m, co, idx, bwd in (
                (n, 64, n, 64, subm.in_idx, plan_bwd_idx(subm)),
                (n, 4, n, 64, subm.in_idx, plan_bwd_idx(subm)),
                (n, 128, n, 64, subm.in_idx, plan_bwd_idx(subm)),
                (n, 64, m_down, 64, down.in_idx, plan_bwd_idx(down)),
                (m_down, 64, n, 64, down.inv_idx, down.in_idx)):
            feats = rand((rows, ci), dtype)
            wgrad.append(_wgrad_case(kernels, feats, rand((m, co), dtype),
                                     bwd, iters))
            function.append(_function_case(
                kernels, GatherConv, feats,
                rand((idx.shape[0], ci, co), torch.float32,
                     (ci * idx.shape[0]) ** -0.5), idx, bwd))
    res["gather_wgrad_cases"] = wgrad
    res["gather_conv_backward_cases"] = function


def _train_golden_model(g, device):
    import torch
    from link_tpu_torch.models.linkunet import ELKUNet
    model = ELKUNet(num_classes=20, cr=float(g["cr"]),
                    capacities=TRAIN_GOLDEN_CAPS, dtype="float32",
                    device=device)
    model.load_state_dict({k[3:].replace("__", "."): torch.from_numpy(
        np.array(g[k])) for k in g.files if k.startswith("sd_")}, strict=True)
    return model


def _train_golden_batches(g):
    from link_tpu_torch.sparse.coords import INVALID_COORD
    out = []
    for i in range(int(g["n_scans"])):
        coords, feats, labels = (g[f"scan{i}_coords"], g[f"scan{i}_feats"],
                                 g[f"scan{i}_labels"])
        # rows into pack-key order (b, z, y, x), as the train step assumes
        order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2],
                            coords[:, 3]))
        coords, feats, labels = coords[order], feats[order], labels[order]
        n, cap = len(coords), TRAIN_GOLDEN_CAPS[0]
        cpad = np.full((cap, 4), INVALID_COORD, np.int32)
        fpad = np.zeros((cap, feats.shape[1]), np.float32)
        lpad = np.zeros((cap,), np.int32)
        cpad[:n], fpad[:n], lpad[:n] = coords, feats, labels
        out.append({"feats": fpad, "coords": cpad, "labels": lpad,
                    "nnz": np.int32(n)})
    return out


def phase_train_grad(res, ctx):
    from link_tpu_torch.train import trainer as T

    g = np.load(TRAIN_GOLDEN)
    batch = _train_golden_batches(g)[0]
    out = {}
    for device in ("cpu", "cuda"):
        model = _train_golden_model(g, device)
        opt = T.make_sgd(model.parameters(), float(g["lr"]))
        m = T.seg_train_step(model, opt, batch)
        out[device] = (float(m["loss"]),
                       {k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
    errs = {k: rel_err(grads_g[k], grads_c[k]) for k in grads_c}
    worst = max(errs, key=errs.get)
    res["train_grad"] = {"loss_cpu": loss_c, "loss_cuda": loss_g,
                         "worst": worst, "worst_rel_err": errs[worst],
                         "leaves": len(errs)}
    log(f"train_grad: loss cpu {loss_c:.6f} card {loss_g:.6f}; {len(errs)} "
        f"gradients, worst rel err {errs[worst]:.3g} ({worst}; tol "
        f"{TRAIN_GRAD_REL_TOL})")
    if abs(loss_c - loss_g) > 1e-4 or not errs[worst] < TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train_grad: loss {loss_c} vs {loss_g}, worst "
                             f"gradient {worst} rel err {errs[worst]}")


def phase_train_golden(res, ctx):
    import torch
    from link_tpu_torch.train import trainer as T

    g = np.load(TRAIN_GOLDEN)
    model = _train_golden_model(g, "cuda")
    batches = _train_golden_batches(g)
    opt = T.make_sgd(model.parameters(), float(g["lr"]), momentum=0.9,
                     weight_decay=1e-4, nesterov=True)
    ref = np.asarray(g["losses"])
    t0 = time.perf_counter()
    # PyTorch's `index_add_` (the backward of the ELK window sum and of
    # the pooling) adds with atomics in no fixed order, and 40 SGD steps
    # amplify that: 14 replays in one process on an H100 put the curve's
    # largest error anywhere from 0.46 to 0.80 of its bound. Deterministic
    # algorithms make every replay the same curve (0.54 of the bound); the
    # hand-written kernels use no atomics and run as they are.
    torch.use_deterministic_algorithms(True)
    try:
        steps = [T.seg_train_step(model, opt, batches[it % len(batches)])
                 for it in range(len(ref))]
        losses = np.asarray([float(m["loss"]) for m in steps])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    res["train_golden"] = {"losses": losses.tolist(),
                           "ref_losses": ref.tolist(),
                           "s": time.perf_counter() - t0}
    # the bounds of tests/test_convergence_ab.py:94-107
    tol = 5e-3 + 0.02 * np.maximum(ref, 0.2) + 2.5e-3 * np.arange(len(ref))
    err = np.abs(losses - ref)
    log(f"train_golden: {len(ref)} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (reference {ref[0]:.4f} -> {ref[-1]:.4f}), max "
        f"|err| {err.max():.4g} at step {int(err.argmax())}")
    if (abs(losses[0] - ref[0]) >= 2e-3 or not (err <= tol).all()
            or abs(losses[-1] - ref[-1]) >= 0.1 + 0.15 * ref[-1]):
        raise AssertionError(f"train_golden: curve left the reference's, "
                             f"max err {err.max()} at step {err.argmax()}")


def phase_train_main(res, ctx, timed_steps=6):
    import torch
    from link_tpu_torch.models import builder
    from link_tpu_torch.nn.modules import SparseBatchNorm, SparseConv3d
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.train import trainer as T
    from link_tpu_torch.utils.config import load_config

    cfg = load_config(SEG_CONFIG)
    caps, ext, batches = (ctx["train_caps"], ctx["train_ext"],
                          ctx["train_batches"])
    if (cfg.batch_size != 2
            or tuple(2 * c for c in cfg.model.capacities) != caps):
        raise AssertionError("the config's batch or capacities changed")
    model = builder.make_model(cfg, capacities=caps, dtype="float32",
                               device="cuda", grid_extent=ext,
                               generator=torch.Generator().manual_seed(0))
    lr = builder.make_lr_schedule(cfg)
    opt = builder.make_optimizer(cfg, model.parameters(), lr(0))
    ignore = cfg.criterion.ignore_index
    torch.cuda.reset_peak_memory_stats()

    def step(it):
        return T.seg_train_step(model, opt, batches[it % len(batches)],
                                ignore_label=ignore, lr=lr(it))

    losses = [float(step(0)["loss"])]                          # warm-up
    torch.cuda.synchronize()
    times = []
    for it in range(1, timed_steps + 1):
        if it == 1:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(it)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if it == 1:
            launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        losses.append(float(m["loss"]))

    convs = sum(1 for mod in model.modules() if isinstance(mod, SparseConv3d)
                and math.prod(mod.kernel_size) > 1)
    # forward: one gather_conv per K>1 conv; backward: one gather_wgrad per
    # conv and one gather_conv (feature gradient) per conv but the stem's
    # first, whose input needs no gradient; joins: 9 plans + 4 ELK windows,
    # as on the inference path
    want = {"gather_conv": 2 * convs - 1, "gather_wgrad": convs,
            "sorted_join": 9 + 4}
    no_grad = [k for k, p in model.named_parameters()
               if p.grad is None or not bool((p.grad != 0).any())]
    still = [k for k, mod in model.named_modules()
             if isinstance(mod, SparseBatchNorm)
             and not bool((mod.running_mean != 0).any())]
    res["train_launches"] = launches
    res["train_losses"] = losses
    res["train_ms_per_step"] = times
    res["train_scans_per_s"] = 2 * len(times) / (sum(times) / 1e3)
    res["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["train_lr"] = [lr(it) for it in range(timed_steps + 1)]
    log(f"train path f32, batch 2, {[int(b['nnz']) for b in batches]} "
        f"voxels: loss per step {[round(v, 4) for v in losses]}; ms per step "
        f"{[round(v, 1) for v in times]}; {res['train_scans_per_s']:.3f} "
        f"training scans/s; launches in one step {launches} (expected "
        f"{want}); peak memory {res['train_peak_mem_gb']:.2f} GB")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"train launch counts {launches} differ from "
                             f"the expected {want}")
    if no_grad or still:
        raise AssertionError(f"parameters without a gradient: {no_grad}; "
                             f"BatchNorms whose running mean stayed 0: "
                             f"{still}")
    ctx.update(train_step=step, train_next=timed_steps + 1)


def phase_train_profile(res, ctx):
    from link_tpu_torch.train.trainer import RANGES
    step, it = ctx["train_step"], ctx["train_next"]
    prof = _profile(lambda: step(it), 1, min(res["train_ms_per_step"]),
                    "step", ranges=RANGES)
    res["train_profile"] = prof
    r = prof.get("ranges")
    if r and r[RANGES[0]]["device_ms"]:
        # autograd issues the backward's kernels from its own thread, so
        # the backward range on the calling thread sees none of them: the
        # backward's device time is what the other two ranges leave
        fwd = r[RANGES[0]]["device_ms"]
        opt = r[RANGES[2]]["device_ms"] or 0.0
        bwd = prof["device_busy_ms_per_step"] - fwd - opt
        prof["device_ms_split"] = {"forward": fwd, "backward": bwd,
                                   "optimizer": opt}
        log(f"train step device time: forward {fwd:.2f} ms, backward "
            f"{bwd:.2f} ms (busy minus the other two), optimizer "
            f"{opt:.2f} ms")


# --------------------------------------------------------------------------
# probe tool


def phase_probes(res, ctx):
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.tools.probe_gather import Probes

    kernels.reset_launch_counts()
    probes = Probes("cuda", iters=8, reps=3, log=log)
    cases = probes.run()
    res["probe_launches"] = {fn.__name__: fn.launches
                             for fn in kernels.KERNELS}
    res["probe_cases"] = cases
    log(f"probes: {len(cases)} cases, each exact against its twin; launches "
        f"{ {k: v for k, v in res['probe_launches'].items() if v} } (per "
        "case: one compared with the twin, one warm, 8 x 3 timed)")
    if min(res["probe_launches"][k] for k in
           ("probe_row_gather", "probe_slab_copy", "probe_empty")) == 0:
        raise AssertionError("a probe kernel was not launched")


def _probe_case(res, kernel, **want):
    """The probe case of `kernel` whose fields equal `want`."""
    for case in res["probe_cases"]:
        if case["kernel"] == kernel and all(case.get(k) == v
                                            for k, v in want.items()):
            return case
    raise KeyError(f"no {kernel} probe case with {want}")


# For each kernel, the case of this run whose error, times and bound stand
# in the kernels line: a shape its main path runs. Other shapes and modes
# are in the details file (OUT_JSON).
KERNEL_CASE = {
    # the seg stem plan's exact join
    "sorted_join": lambda res: res["sorted_join"],
    # seg K=27, 64 channels, float32
    "gather_conv": lambda res: res["gather_conv_cases"][0],
    # det level 0, 16 channels, float32
    "window_conv": lambda res: res["window_conv_cases"][0],
    # training level 0: N=M=169,984, K=27, 64 channels, float32
    "gather_wgrad": lambda res: res["gather_wgrad_cases"][0],
    # the 27 taps of a real plan over 169,984 rows of 256 B
    "probe_row_gather": lambda res: _probe_case(
        res, "probe_row_gather", letter="P", n=169984, row_bytes=256,
        q=27 * 169984),
    # 512 slabs of 512 rows of 256 B (128 KB of shared memory each)
    "probe_slab_copy": lambda res: _probe_case(
        res, "probe_slab_copy", letter="D", g=512),
    "probe_empty": lambda res: _probe_case(res, "probe_empty"),
}
MAIN_PATHS = {"seg": "launches", "det": "det_launches",
              "train": "train_launches", "probes": "probe_launches"}


def kernels_line(res):
    """One entry per kernel of `kernels.KERNELS` (name, source and what it
    replaces come from that registry): launches summed over the main paths'
    counted runs (one seg pass of 4 scans, one det pass of 2 frames, one
    train step, one run of the probe tool), and the error, times and bound
    of `KERNEL_CASE`. A kernel without a case or without a launch on any
    main path fails the script."""
    from link_tpu_torch.ops import kernels
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entries = []
    for fn in kernels.KERNELS:
        name = fn.__name__
        case = KERNEL_CASE[name](res)
        by_path = {path: res[key].get(name, 0)
                   for path, key in MAIN_PATHS.items()}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"{name} was launched on no main path")
        entries.append({
            "name": name, "route": "cuda",
            "source": "link_tpu_torch/csrc/" + fn.source,
            "replaces": fn.replaces, "launches": sum(by_path.values()),
            **{k: case[k] for k in keys}, "shape": case.get("shape")
            or case.get("name"), "launches_by_path": by_path})
    return {"kernels": entries}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "link_tpu_torch")):
        print("chip_smoke: link_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # f32 parity runs in full float32 (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    res = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    card = card_line()
    res["card"] = card
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    ctx = {}
    for phase in (phase_build, phase_kernels, phase_golden, phase_main,
                  phase_profile, phase_det_kernels, phase_det_golden,
                  phase_det_main, phase_det_profile, phase_train_kernels,
                  phase_train_grad, phase_train_golden, phase_train_main,
                  phase_train_profile, phase_probes):
        t0 = time.perf_counter()
        phase(res, ctx)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    res["total_s"] = time.perf_counter() - t_start

    line = kernels_line(res)
    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON, "w") as f:
        json.dump({**res, **line}, f, indent=1)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
