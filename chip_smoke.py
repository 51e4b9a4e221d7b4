#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`link_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order (any failure raises and the script exits non-zero):
  1. build   compile every CUDA kernel from `link_tpu_torch/csrc/` with nvcc
             (sm_90a) and print the card's name and power limit;
  2. kernels hold each kernel against its plain PyTorch twin at the main
             path's shapes (84,992-row tables from a synthetic 80k-voxel
             scan), and time kernel, twin and the library yardstick;
  3. golden  ELKUNet cr1.0 float32 (TF32 off) at DEFAULT_CAPACITIES on the
             real 80k-voxel scan of tests/goldens/elkunet_cr1.0_fullscale.npz
             with the reference weights, against the reference logits;
  4. main    the main path: bfloat16 ELKUNet cr1.0 with seeded random
             weights on 4 synthetic 80k-voxel scans, with the launch counts
             of both kernels read around one pass, and scans/s;
  5. profile one more pass of the main path under torch.profiler: device
             time by kernel, and the device's idle share against the
             unprofiled wall time of phase 4.

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
OUT_JSON = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
PHASES = ("build", "kernels", "golden", "main", "profile")

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

    # --- sorted_join: 84,992-row table, 27 x 84,992 queries (stem plan)
    table = C.build_table(st.coords, assume_sorted=True)
    offs = torch.tensor(C.kernel_offsets_np(3), dtype=torch.int32, device=dev)
    q = torch.cat([st.coords[None, :, :3] + offs[:, None, :],
                   st.coords[None, :, 3:].expand(27, -1, -1)], -1)
    q_hi, q_lo = C.pack_coords(q.reshape(-1, 4))
    args = (table.hi, table.lo, table.perm, q_hi, q_lo)
    got = kernels.sorted_join(*args)
    want = kernels.sorted_join_plain(*args)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"sorted_join: {mismatches} of {got.numel()} "
                             "results differ from the twin")
    tkey = kernels.key64(table.hi, table.lo)
    qkey = kernels.key64(q_hi, q_lo)

    def library_join():
        pos = torch.searchsorted(tkey, qkey).clamp_(max=n - 1)
        hit = (tkey[pos] == qkey) & (q_hi != C.INT32_MAX)
        return torch.where(hit, table.perm[pos], -1)

    nq = q_hi.numel()
    probes = math.ceil(math.log2(n + 1))
    t_bytes = (3 * n * 4 + 3 * nq * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 3.0 * nq * probes / PEAK_OPS["int32"] * 1e3
    join = {
        "shape": f"N={n} Q={nq} int32",
        "max_abs_err": 0.0, "hits": int((got >= 0).sum()),
        "ms": cuda_ms(lambda: kernels.sorted_join(*args), iters),
        "plain_ms": cuda_ms(lambda: kernels.sorted_join_plain(*args), iters),
        "library_ms": cuda_ms(library_join, iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"sorted_join {join['shape']}: exact, kernel {join['ms']:.4f} ms, "
        f"twin {join['plain_ms']:.4f} ms, searchsorted "
        f"{join['library_ms']:.4f} ms, bound {join['bound_ms']:.4f} ms "
        f"({join['bound_by']}), hits {join['hits']}")
    res["sorted_join"] = join

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


def phase_profile(res, ctx):
    """Device time by kernel over one pass of the main path's scans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, scans, fresh = ctx["model"], ctx["scans"], ctx["fresh"]
    with torch.inference_mode():
        inputs = [fresh(st) for st in scans]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                model(x)
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / len(scans)
    wall_ms = 1e3 / max(res["scans_per_s"])
    by_name = sorted(((e.self_device_time_total / 1e3 / len(scans), e.count
                       // len(scans), e.key) for e in kern), reverse=True)
    res["profile"] = {
        "device_busy_ms_per_scan": busy_ms or None,
        "wall_ms_per_scan": wall_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "launches_per_scan": sum(e.count for e in kern) / len(scans),
        "kernel_kinds": len(kern),
        "kernels": [{"ms_per_scan": t, "launches_per_scan": c, "name": k[:160]}
                    for t, c, k in by_name[:25]],
    }
    if not busy_ms:
        log("profile: no device time in the trace (not measured)")
        return
    log(f"profile: device busy {busy_ms:.2f} ms per scan of {wall_ms:.2f} ms "
        f"wall (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{res['profile']['launches_per_scan']:.0f} kernel launches per scan "
        f"of {len(kern)} kinds")
    for t, c, k in by_name[:12]:
        log(f"  {t:8.3f} ms {t / busy_ms:6.1%} x{c:<5d} {k[:90]}")


def kernels_line(res):
    src = "link_tpu_torch/csrc/"
    rep = "link_tpu/ops/pallas_kernels.py:"
    join = res["sorted_join"]
    conv = res["gather_conv_cases"][0]          # K=27, Ci=Co=64, float32
    launches = res["launches"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"kernels": [
        {"name": "sorted_join", "route": "cuda",
         "source": src + "sorted_join.cu", "replaces": rep + "62",
         "launches": launches["sorted_join"],
         **{k: join[k] for k in keys}},
        {"name": "gather_conv", "route": "cuda",
         "source": src + "gather_conv.cu", "replaces": rep + "111",
         "launches": launches["gather_conv"],
         **{k: conv[k] for k in keys}},
    ]}


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
    steps = {"build": phase_build, "kernels": phase_kernels,
             "golden": phase_golden, "main": phase_main,
             "profile": phase_profile}
    ctx = {}
    for p in PHASES:
        t0 = time.perf_counter()
        steps[p](res, ctx)
        log(f"phase {p}: {time.perf_counter() - t0:.1f} s")
    res["total_s"] = time.perf_counter() - t_start

    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON, "w") as f:
        json.dump(res, f, indent=1)
    print(card)
    print(json.dumps(kernels_line(res)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
