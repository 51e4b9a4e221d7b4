"""Where the conv kernels' time goes on the card, phase by phase.

    python3 -m link_tpu_torch.tools.conv_phases [--kernel gather|window]

Builds csrc/gather_conv.cu once more with -DGATHER_CONV_PHASES, which makes
warp 1 of every block count the SM clock cycles it spends in each phase
(compacting the tile's hits, waiting for a stage, issuing the next stage's
gathers, the MMAs with their W loads, adding into the accumulator, writing
the tile), and runs it on the stem plan of a synthetic 80k-voxel scan
(84,992 rows, K = 27, 64 -> 64 channels, the case `chip_smoke.py` holds
against the twin), float32 and bfloat16. One line per dtype: the kernel's
time with the counters on (CUDA events), the (64-row tile, tap) pairs with
a hit and the megabytes of W they read from L2 (and, for comparison, what
128-row tiles would read), and the mean cycles per block by phase, per
stage, and of the slowest block. The counters cost a few percent; the
library built with them is used by this tool alone.

With --kernel window it builds csrc/window_conv.cu with
-DWINDOW_CONV_PHASES instead (lane 0 of every warp counts its cycles in
staging W, waiting for a tile's base rows and slots, setting up and issuing
the group spans, waiting for a span, routing and multiplying, and writing
its tiles) and runs it on the det window plans (level 0 16 -> 16 and 5 ->
16, level 1 32 -> 32; float32 and bfloat16): one line per case with the
mean cycles per warp by phase, its tiles and its (tile, group) pairs with a
hit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from ..ops import kernels

PHASES = ("compact", "wait", "issue", "compute", "flush", "store", "total",
          "stages")
TILE_ROWS = 64          # output rows per block of the kernel (gather_conv.cu)


def build() -> ctypes.CDLL:
    """The instrumented gather_conv library, built into kernels.BUILD_DIR
    beside the plain one (named by the same hash)."""
    plain = kernels._so_path("gather_conv.cu")
    so = plain.with_name(plain.stem + "-phases.so")
    if not so.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DGATHER_CONV_PHASES",
               "-o", str(so), str(kernels.CSRC / "gather_conv.cu")]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    lib.gather_conv.argtypes = kernels.gather_conv.argtypes
    lib.gather_conv.restype = ctypes.c_int
    lib.gather_conv_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gather_conv_phases.restype = ctypes.c_int
    return lib


def seg_plan(device) -> torch.Tensor:
    """(27, 84,992) kernel map of the stem's submanifold plan."""
    from ..data.collate import collate_scans, to_sparse_tensor
    from ..data.semantic_kitti import SyntheticSemanticKITTI, grid_extent
    from ..models.linkunet import DEFAULT_CAPACITIES
    from ..sparse import coords as C
    from ..sparse.conv import build_conv_plan
    ds = SyntheticSemanticKITTI(length=1, num_points=80000,
                                n_raw_points=120000, split="train")
    ext = grid_extent(0.05, batch_size=1)
    st = to_sparse_tensor(collate_scans([ds[0]], DEFAULT_CAPACITIES[0],
                                        grid_extent=ext),
                          device=device, grid_extent=ext)
    return build_conv_plan(st.coords, st.coords, st.nnz,
                           C.kernel_offsets_np(3), st.capacity,
                           in_sorted=True).in_idx


def live_pairs(idx: torch.Tensor, tile_rows: int) -> int:
    """(tile, tap) pairs with at least one hit, for tiles of `tile_rows`
    output rows: each reads its slice of W[tap] once."""
    k, n = idx.shape
    blocks = -(-n // tile_rows)
    pad = torch.full((k, blocks * tile_rows - n), -1, dtype=idx.dtype,
                     device=idx.device)
    return int((torch.cat([idx, pad], 1).reshape(k, blocks, tile_rows)
                >= 0).any(-1).sum())


def run(iters: int = 20, log=print):
    lib = build()
    dev = torch.device("cuda")
    idx = seg_plan(dev)
    k, n = idx.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn((n, 64), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, 64, 64), generator=gen, device=dev)
             * 0.125).to(dtype)
        out = torch.empty((n, 64), dtype=dtype, device=dev)
        w_frag = torch.empty(kernels.conv_w_frag_bytes(k, 64, 64, dtype),
                             dtype=torch.uint8, device=dev)

        def call():
            rc = lib.gather_conv(
                feats.data_ptr(), n, 64, idx.data_ptr(), k, n, w.data_ptr(),
                64, w_frag.data_ptr(), out.data_ptr(),
                0 if dtype == torch.float32 else 1,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"gather_conv: cudaError {rc}")
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        blocks = -(-n // TILE_ROWS)
        buf = np.zeros((blocks, len(PHASES)), np.int64)
        rc = lib.gather_conv_phases(buf.ctypes.data, blocks)
        if rc:
            raise RuntimeError(f"gather_conv_phases: cudaError {rc}")
        mean = buf.mean(0)
        # W read per launch: a block reads W[tap] (64 x 64 here) once for
        # every tap with a hit in its rows
        w_mb = {tm: live_pairs(idx, tm) * 64 * 64 * out.element_size() / 1e6
                for tm in (TILE_ROWS, 2 * TILE_ROWS)}
        row = {"dtype": str(dtype).split(".")[1], "ms": ms, "blocks": blocks,
               "live_block_taps": live_pairs(idx, TILE_ROWS),
               "w_read_mb": w_mb,
               "cycles_per_block": dict(zip(PHASES, mean.tolist())),
               "slowest_block_cycles": int(buf[:, 6].max())}
        rows.append(row)
        per_stage = {p: mean[i] / max(mean[7], 1)
                     for i, p in enumerate(PHASES[1:5], 1)}
        log(f"{row['dtype']:8s}: {ms:.4f} ms, {blocks} blocks, "
            f"{row['live_block_taps']} (tile, tap) pairs with a hit, W read "
            f"{w_mb[TILE_ROWS]:.1f} MB (128-row tiles would read "
            f"{w_mb[2 * TILE_ROWS]:.1f} MB); cycles per block " + ", ".join(
                f"{p} {v:.0f}" for p, v in zip(PHASES, mean))
            + "; per stage " + ", ".join(
                f"{p} {v:.0f}" for p, v in per_stage.items())
            + f"; slowest block {row['slowest_block_cycles']}")
    return rows


WINDOW_PHASES = ("stage W", "wait meta", "span setup", "wait span",
                 "compute", "store", "total", "tiles", "groups")
WINDOW_MAX_WARPS = 1 << 16   # PHASE_WARPS of window_conv.cu


def build_window() -> ctypes.CDLL:
    """The instrumented window_conv library (-DWINDOW_CONV_PHASES)."""
    plain = kernels._so_path("window_conv.cu")
    so = plain.with_name(plain.stem + "-phases.so")
    if not so.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DWINDOW_CONV_PHASES",
               "-o", str(so), str(kernels.CSRC / "window_conv.cu")]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    lib.window_conv.argtypes = kernels.window_conv.argtypes
    lib.window_conv.restype = ctypes.c_int
    lib.window_conv_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.window_conv_phases.restype = ctypes.c_int
    return lib


def det_window_plans(device):
    """The window-form SubM plans of det levels 0 and 1 of one synthetic
    160k-voxel nuScenes frame (163,840 and 81,920 rows), as `chip_smoke.py`
    builds them."""
    from ..data import det_pipeline as dp
    from ..data.nuscenes import SyntheticNuScenes
    from ..models.scn import DET_CAPACITIES
    from ..sparse import coords as C
    from ..sparse.conv import add_window_form, build_conv_plan
    from ..sparse.spconv_engine import spconv_downsample, spconv_out_shape
    ds = SyntheticNuScenes(length=1, mode="val", seed=0, max_voxels=160000)
    batch = dp.collate_det([ds[0]], DET_CAPACITIES[0])
    coords = torch.from_numpy(batch["coords"]).to(device)
    nnz = torch.tensor(int(batch["nnz"]), dtype=torch.int32, device=device)
    offs = C.kernel_offsets_np(3)
    plans = []
    for lvl in range(2):
        if lvl:
            shape = spconv_out_shape((1440, 1440, 41), (3, 3, 3), (2, 2, 2),
                                     (1, 1, 1))
            coords, nnz = spconv_downsample(coords, (3, 3, 3), (2, 2, 2),
                                            (1, 1, 1), shape,
                                            DET_CAPACITIES[1])
        table = C.build_table(coords, assume_sorted=True)
        plans.append(add_window_form(
            build_conv_plan(coords, coords, nnz, offs, coords.shape[0],
                            in_sorted=True, table=table), table, offs, 1))
    return plans


def run_window(iters: int = 20, log=print):
    """Phase cycles of `window_conv` on the det plans: level 0 16 -> 16 and
    5 -> 16, level 1 32 -> 32, float32 and bfloat16."""
    lib = build_window()
    dev = torch.device("cuda")
    plans = det_window_plans(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for lvl, ci, co in ((0, 16, 16), (0, 5, 16), (1, 32, 32)):
            plan = plans[lvl]
            k, m = plan.slot.shape
            feats = torch.randn((m, ci), generator=gen, device=dev).to(dtype)
            w = (torch.randn((k, ci, co), generator=gen, device=dev)
                 * (27 * ci) ** -0.5).to(dtype)
            out = torch.empty((m, co), dtype=dtype, device=dev)
            taps, goff = kernels._group_arrays(plan.groups, dev)
            gw = max(len(t) for t in plan.groups)

            def call():
                rc = lib.window_conv(
                    feats.data_ptr(), m, ci, plan.base_pos.data_ptr(),
                    plan.slot.data_ptr(), m, taps.data_ptr(),
                    goff.data_ptr(), len(plan.groups), k, gw, w.data_ptr(),
                    co, out.data_ptr(), 0 if dtype == torch.float32 else 1,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"window_conv: cudaError {rc}")
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
            buf = np.zeros((WINDOW_MAX_WARPS, len(WINDOW_PHASES)), np.int64)
            lib.window_conv_phases(buf.ctypes.data, WINDOW_MAX_WARPS)  # reset
            call()
            torch.cuda.synchronize()
            rc = lib.window_conv_phases(buf.ctypes.data, WINDOW_MAX_WARPS)
            if rc:
                raise RuntimeError(f"window_conv_phases: cudaError {rc}")
            live = buf[buf[:, 6] > 0]
            mean = live.mean(0)
            row = {"dtype": str(dtype).split(".")[1], "level": lvl,
                   "ci": ci, "co": co, "ms": ms, "warps": len(live),
                   "cycles_per_warp": dict(zip(WINDOW_PHASES,
                                               mean.tolist())),
                   "slowest_warp_cycles": int(live[:, 6].max())}
            rows.append(row)
            log(f"window {row['dtype']:8s} level {lvl} {ci}->{co}: {ms:.4f} "
                f"ms (events), {len(live)} warps; mean per warp "
                + ", ".join(f"{p} {v:.0f}"
                            for p, v in zip(WINDOW_PHASES, mean))
                + f"; slowest warp {row['slowest_warp_cycles']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("gather", "window"),
                    default="gather")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv_phases needs a CUDA device")
    print("device", torch.cuda.get_device_name(0))
    run() if args.kernel == "gather" else run_window()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
