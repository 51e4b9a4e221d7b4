#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`link_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, one card

Phases, in order (any failure raises and the script exits non-zero):
  1. build       compile every CUDA kernel from `link_tpu_torch/csrc/` with
                 nvcc (sm_90a), all sources at once, and print the card's
                 name and power limit;
  2. kernels     hold each kernel against its plain PyTorch twin at the seg
                 path's shapes (84,992-row tables from a synthetic 80k-voxel
                 scan: `sorted_join` at the stem, the down plan, the ELK
                 aux window and K = 1, exactly), the conv kernel also
                 bit-equal over two runs, and time kernel, twin and the
                 library yardstick;
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
  5b. seg_families_golden the ELKEncoder, MinkUNet and SPVCNN goldens
                 (tests/goldens/{elkencoder,minkunet,spvcnn}_cr0.25.npz,
                 reference weights) in float32 at DEFAULT_CAPACITIES against
                 the reference logits, rel err < 2e-4; the encoder through
                 its sparse aux join and, with a grid extent, its dense aux
                 grid on every level;
  5c. seg_families_main each family from its config
                 (configs/semantic_kitti/{linkencoder,minkunet,spvcnn}) by
                 `make_model` at cr1.0 and full depth, seeded random
                 weights, on phase 4's scans (the encoder and MinkUNet in
                 bfloat16, SPVCNN in float32): launch counts around one
                 pass (`gather_conv` once per K>1 conv; `sorted_join` once
                 per plan, sparse ELK window, `upsample_voxel` and SPVCNN
                 point join), scans/s (best of 3 rounds of 4), and one more
                 pass profiled: device time, idle share, the two kernels'
                 ms, the join-site check, and the ms and launches of the
                 join inputs that the new sites form in PyTorch before
                 their join (range `coords.JOIN_INPUT_RANGE`, entered once
                 per `upsample_voxel` and uncached point join); the
                 encoder's aux path per level;
  5d. seg_families_hold each family at cr1.0 in float32 on phase 4's scan
                 0, the card against the CPU (plain twins), same weights,
                 rel err < 2e-4;
  5e. seg_families_eval `link_tpu_torch.tools.seg_evaluate` on the card for
                 each family (a checkpoint of 5c's model, the synthetic val
                 split, 2 scans at the config's capacities x 1.6):
                 point-level mIoU and ms per scan;
  6. det_kernels `window_conv` and the three modes of `sorted_join` against
                 their twins at the det path's shapes (163,840-row level 0
                 and 81,920-row level 1 of one synthetic 160k-voxel
                 nuScenes frame, the down plan between them, and level 0
                 cut to a row count that is no multiple of 16), the join
                 also on a shuffled table, unsorted base rows, padding
                 rows in the middle and out-of-range queries (exactly
                 equal), `window_conv` also bit-equal over two runs, timed
                 with twin and library yardstick, and `gather_conv` on
                 the same plan's kernel map beside it;
  7. det_golden  the RPN + CenterHead in float32 (TF32 off) with the
                 reference weights of tests/goldens/det_dense.npz against its
                 RPN output and head maps;
  7b. det_elk_golden the reference TSELKBlock at the det capacity
                 (tests/goldens/tselk_cos_fullscale.npz, 163,840 rows) in
                 float32 through the sparse aux path (its joins through
                 `sorted_join`) and the dense one;
  8. det_main    the det serving path: SingleFramePredictor, bfloat16
                 CenterPoint-ELKv3 with seeded random weights at the 160k
                 val capacity, on 2 synthetic frames: launch counts of the
                 kernels around one pass, frames/s of forward + decode, ms per
                 end-to-end `predict` (host voxelize and NMS included), boxes;
  9. det_profile one det forward + decode per frame under torch.profiler:
                 device time by kernel and the device's idle share; the
                 seg, det and train profiles also read the join sites'
                 range (`coords.JOIN_RANGE`: host ms, device ms, launches)
                 and fail unless it holds only `sorted_join`'s launches;
  9b. det_nms_kernels `rotated_nms` against its twin on the det frames'
                 real candidates (6 tasks, the top 1,000 each) and on
                 synthetic sets (N = 1, 63, 64, 65, 1,000; identical,
                 zero-width and invalid rows, tied scores; thresholds 0.01,
                 0.2, 0.5; max_keep 83 and N), each as a singleton call:
                 the kernel's IoU within 1e-6 of `native.bev_iou`, keep
                 masks equal, a pair decided differently only within 1e-5
                 of the threshold (counted and printed); and each as a set
                 of a batched call (a frame's 6 tasks in one call; the
                 synthetic sets padded to N = 1,000), equal to its
                 singleton call; the frame's call timed whole and launch
                 by launch, beside its twin, bound and launch floor; and
                 every case again through the build that sends every
                 clipped pair through the overflow redo
                 (`rotated_nms_clip_redo`): the same keep, its IoU within
                 1e-6 of the normal build's;
  9c. det_serve  under PyTorch's own TF32 flags, as a user's process has
                 them: `predict` per frame with host native NMS and with
                 device NMS, split into voxelize, forward + decode (+
                 device NMS), copies, host NMS and floors; the launches of one
                 device-NMS pass (one `rotated_nms` call per frame); both
                 modes' kept boxes from the same decode outputs; and
                 `stream_inference --synthetic 3 --device-nms`;
  9d. det_flip_golden `double_flip_fuse` + `decode_boxes(double_flip=True)`
                 on the card against tests/goldens/det_flip.npz (boxes
                 rtol 1e-4 / atol 1e-5, scores rtol 1e-5, labels exact),
                 and the same maps card against CPU (< 1e-5);
  9e. det_tta_main det_test's double-flip path: bfloat16 CenterPoint-ELKv3,
                 seed-0 weights, each val frame of `write_synthetic_infos`
                 (10 sweeps, 200k points; written to a temporary
                 directory) as a batch of its 4 flips at capacity 655,360,
                 fused at decode, device NMS: launches per frame around
                 one pass (one `rotated_nms` call), ms per frame, the
                 profile (device busy, idle share, join sites) and peak
                 memory; then the batch-4 forward in float32 against the
                 four batch-1 forwards of the same flips (every head map
                 < 1e-5) on a frame whose every level fits its capacity;
 10. train_kernels the weight-gradient work list built on the card against
                 its plain twin; `gather_wgrad` against its twin, and the
                 conv's whole
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
 14a. seg_families_train ELKEncoder, MinkUNet and SPVCNN each trained by
                 its config's recipe (cr 1.0, the config's capacities x
                 batch 2, float32, SGD under cosine_warmup; SPVCNN with its
                 seeded dropout) on batches read back through
                 `SemanticKITTI` from a tree of synthetic 120k-point scans
                 written in the dataset's layout to a temporary directory:
                 1 warm and 6 timed steps (ms per step, launches of each
                 kernel in one step against the expected counts, peak
                 memory), then one step profiled (device busy ms, idle
                 share, the join-site check);
 14a'. seg_families_train_grad one step of each of the three at the
                 tests' tiny size (cr 0.125, capacities (384, 192, 96, 48,
                 24), two synthetic scans of seed 11; SPVCNN without
                 dropout) on the card against the CPU: loss, and every
                 gradient < 1e-4 of the largest, the CPU's ReLUs given the
                 card's side as in det_train_grad;
 14a''. seg_files `seg_train` without --synthetic on the written tree
                 (MinkUNet's recipe, 2 epochs, the second resumed), then
                 `seg_evaluate` on its checkpoint: --tta 1 against the
                 plain forward (equal but for softmax ties, at most 1e-4
                 of the points), --tta 4 (finite votes), --split test
                 --save-labels (one uint32 per point of each test scan);
                 then `train_supervisor` over a child that exits 17 after
                 epoch 1 and completes on its relaunch (the tools' output
                 in chiprun_out/seg_files.log);
 14b. det_train_kernels `window_conv` and the backward of the window-form
                 conv (`WindowConv`) at the det step's level-0 plan (two
                 synthetic frames at 327,680 rows): the forward at 5 -> 16
                 and 16 -> 16, the feature gradient (`window_conv` over the
                 plan's windows with W[mirror]^T) and weight gradient
                 (`gather_wgrad` over the mirrored map) against their
                 twins, f32 < 1e-5 and bit-equal over two runs, the whole
                 backward through autograd against autograd through the
                 plain conv, timed beside `GatherConv`'s backward on the
                 same plan; the stem's weight gradient (5 -> 16; no
                 feature gradient); and level 1 (163,840 rows, 32
                 channels), off the f32 step's path, alike;
 14c. det_train_grad one det step of the tiny VoxelNet of
                 tests/test_det_train_step.py on the card against the same
                 step on the CPU, the CPU's ReLUs given the card's side
                 where |x| lies below 1e-4 of the call's largest |x| (an
                 input on the other side must lie there): loss, and every
                 gradient < 1e-4 of the largest gradient; the CPU step on
                 its own sides is read beside;
 14d. det_train_golden the 40 float64 steps of
                 tests/goldens/det_train_ab.npz (RPN + CenterHead,
                 one-cycle Adam) replayed on the card against the
                 reference's loss curve;
 14e. det_train_main det_train's default recipe at full width:
                 CenterPoint-ELKv3 f32, 2 synthetic frames a step at
                 capacities (327,680, 163,840, 81,920, 40,960), one-cycle
                 Adam; 1 warm and 6 timed steps: ms per step, frames/s,
                 launches of each kernel in one step (window_conv and
                 gather_conv forward and backward apart), losses, peak
                 memory;
 14f. det_train_profile one more step under torch.profiler: device time by
                 kernel, idle share, the forward / backward / optimizer
                 split and the join-site check;
 14g. det_train_cli `python3 -m link_tpu_torch.tools.det_train --synthetic
                 --epochs 1` in a fresh process (4 steps into
                 chiprun_out/det_train_run): losses and the peak memory of
                 a fresh process;
 14h. det_files  the det tools on the nuScenes-format files, under a user's
                 TF32 flags: `create_data` gt_database; `det_train` with
                 --db-info-path, 2 epochs, the second resumed with
                 --no-aug-from 2 (GT-AUG on, then off); `det_test` on the
                 checkpoint (host NMS, --device-nms, --double-flip,
                 --tt-rotation 12.5) and on the seed-0 weights (host,
                 device, rotated): mAP and NDS finite, host and device NMS
                 the same boxes on the same decode outputs but for pairs
                 within 1e-5 of the threshold; `tta_fuse --fuse-only` on
                 two rotations' JSONs; launches per tool run (no twin: each
                 kernel of the path launched); log in
                 chiprun_out/det_files.log;
 15. path_shapes `gather_conv` and `gather_wgrad` against their twins,
                 bit-equal over two runs, at every distinct shape and dtype
                 of one more seg pass, det pass, seg training step and det
                 training step (their inputs recorded as the paths make
                 them); then one more
                 pass of each seg family: `gather_conv` at each (K, Ci, Co,
                 dtype) no earlier path gives it (f32 rel < 1e-5, bf16 <
                 8e-3, bit-equal over two runs, timed with its bound and
                 launches per scan), and `sorted_join` exactly against its
                 twin at every call of the new join sites
                 (`upsample_voxel`, `voxel_to_point`, `point_to_voxel`);
                 then one more training step of each of the three
                 families (14a): `gather_conv` against its twin and
                 `gather_wgrad` against the float64 sum (< 1e-5 of the
                 largest entry) at every shape of each step, on its own
                 inputs, each timed beside its bound with its launches per
                 step; then one more double-flip forward (9e) in bfloat16
                 and in float32: `gather_conv` and `window_conv` against
                 their twins at each of its shapes (batch 4, 655,360
                 level-0 rows), `sorted_join` exactly at each of its 9
                 calls, each timed beside its bound;
 16. probes      every case of `link_tpu_torch.tools.probe_gather` (the
                 Mosaic probes' shapes and the port's own), each exact
                 against its twin, timed beside its bound and the library
                 gather; then 6 interleaved readings (kernel, library,
                 library, kernel, ...) of the one-hot probe's shapes (4c)
                 against `x[idx]` and of the empty launch against `clone`,
                 with medians and spreads; then, outside the counted run,
                 the edges of the two probe kernels' work layouts
                 (`Probes.edges`: slabs above one block's shared memory,
                 of no whole number of stages, out_rows = G, fewer and far
                 more slabs than the grid's blocks, offsets -1 and N - G +
                 1;
                 rows of 2 to 1,024 B, 3 vectors a row, Q = 1 and 1,001,
                 indices >= N, rows of 5-6 vectors at Q = 1.5-2 million
                 for the kernel of 4 items a lane), each bit-equal against
                 its twin.

`gather_wgrad` is held against its twin's sum in float64: a weight
gradient can cancel a thousandfold (the det stem's), and the float32 twin's
own rounding then takes most of the 1e-5 bound.

A kernel, twin or library call is timed as the mean over the replay of a
CUDA graph of back-to-back calls, so that it reads the card's time and not
the host's launch interval (a failed capture is reported and a CUDA-event
time, paced by the host, kept). The golden forward is timed by CUDA events
around whole calls, the rates by the host clock around synchronized work.

Output: `#`-prefixed progress lines, then a line with the card's name and
power limit (nvidia-smi), then one JSON line {"kernels": [...]} with each
kernel's launches on the main paths, error against its twin, times and bound,
and last {"ok": true, "device": {...}}. Details also go to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device or when
the `link_tpu_torch` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "goldens", "elkunet_cr1.0_fullscale.npz")
DET_GOLDEN = os.path.join(HERE, "tests", "goldens", "det_dense.npz")
TRAIN_GOLDEN = os.path.join(HERE, "tests", "goldens", "train_ab.npz")
TSELK_GOLDEN = os.path.join(HERE, "tests", "goldens",
                            "tselk_cos_fullscale.npz")
TRAIN_GOLDEN_CAPS = (1024, 640, 256, 128, 64)
SEG_CONFIG = os.path.join(HERE, "configs", "semantic_kitti", "linkunet",
                          "default.yaml")
OUT_JSON = os.path.join(HERE, "chiprun_out", "chip_smoke.json")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and per-type rates.
# int32 on the CUDA cores runs at half the float32 rate (64 INT32 lanes vs
# 128 FP32 lanes per SM).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int32": 33.5e12}
# The conv kernels' products run on the tensor cores: bfloat16 on the bf16
# MMA, float32 as three TF32 passes (csrc/mma_sm90.cuh), so float32-accurate
# products at a third of the 495 TFLOP/s TF32 rate. PEAK_OPS["float32"] (the
# CUDA cores) stays the yardstick of the PR 3 kernels' bounds, kept beside.
TC_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}

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


CAPTURE_FAILED = []    # "label: error" of each call not timed by a graph
USER_TF32 = {}         # PyTorch's own TF32 flags, before main() clears them


def cuda_ms(fn, iters: int, label: str = "") -> float:
    """Mean device time of fn over `iters` calls (warm), from the replay of
    a CUDA graph of those calls, so that it reads the card's time and not
    the host's launch interval (`link_tpu_torch.utils.timing.device_ms`). A
    capture that fails is reported, and the event time, paced by the host,
    kept."""
    from link_tpu_torch.utils.timing import device_ms
    ms, mode = device_ms(fn, iters)
    if mode != "graph":
        CAPTURE_FAILED.append(f"{label}: {mode}")
        log(f"{label or 'a call'}: {mode}; the event time is kept")
    return ms


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
        entry = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"{src}: {entry}: {line.strip()}")
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


def _conv_case(kernels, feats, idx, weight, iters, role=""):
    """Kernel vs twin on one conv shape: error, two runs bit-equal, times,
    bound (and PR 3's CUDA-core bound beside it)."""
    import torch
    got = kernels.gather_conv(feats, idx, weight)
    again = kernels.gather_conv(feats, idx, weight)
    want = kernels.gather_conv_plain(feats, idx, weight)
    torch.cuda.synchronize()
    dt = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    err = rel_err(got, want)
    tol = BF16_REL_TOL if dt == "bfloat16" else F32_REL_TOL
    n, ci = feats.shape
    k, m = idx.shape
    co = weight.shape[2]
    isz = feats.element_size()
    hits = int(((idx >= 0) & (idx < n)).sum())
    nbytes = n * ci * isz + k * m * 4 + k * ci * co * isz + m * co * isz
    ops = 2.0 * hits * ci * co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / TC_OPS[dt] * 1e3
    shape = f"N={n} M={m} K={k} Ci={ci} Co={co} {dt}"
    case = {
        "shape": shape, "role": role,
        "rel_err": err, "tol": tol,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "same_twice": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: kernels.gather_conv(feats, idx, weight), iters,
                      f"gather_conv {shape}"),
        "plain_ms": cuda_ms(
            lambda: kernels.gather_conv_plain(feats, idx, weight), iters,
            f"gather_conv_plain {shape}"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_cuda_core_ms": max(t_bytes, ops / PEAK_OPS[dt] * 1e3),
        "library_ms": None, "hits": hits,
    }
    log(f"gather_conv {shape}{' (' + role + ')' if role else ''}: rel err "
        f"{err:.3g} (tol {tol}), same twice {case['same_twice']}, kernel "
        f"{case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms ({case['bound_by']}), hits {hits}")
    if not err < tol:
        raise AssertionError(f"gather_conv {shape}: rel err {err} >= {tol}")
    if not case["same_twice"]:
        raise AssertionError(f"gather_conv {shape}: two runs differ")
    return case


def _join_case(kernels, table, base, offsets, mode, iters, mult=None,
               role=""):
    """sorted_join vs its twin on one join site: the kernel forms the
    queries from `base` (times `mult`) and the offsets; every output must
    equal the twin's exactly. Times: the kernel (both launches in mode
    "window"), the twin (the whole site as plain PyTorch ops), and the
    library call, `torch.searchsorted` on keys packed beforehand (the
    search alone). Bound: base rows (16 B) and outputs written once, the
    table's keys (and perm in mode "exact") read once; against 3 int32
    operations per probe of one search per group anchor and one compare
    per tap. `bound_old_ms` is the bound of the kernel alone under the
    packed-key contract (packed queries read, results written), kept
    beside it."""
    import torch
    args = (table.hi, table.lo, table.perm, base, offsets, mult, mode)
    got = kernels.sorted_join(*args)
    want = kernels.sorted_join_plain(*args)
    torch.cuda.synchronize()
    if mode != "window":
        got, want = (got,), (want,)
    mismatches = sum(int((g != w).sum()) for g, w in zip(got, want))
    shape_ok = all(g.shape == w.shape and g.dtype == w.dtype
                   for g, w in zip(got, want))
    n, m = table.hi.numel(), base.shape[0]
    k = 1 if offsets is None else len(offsets)
    glist = kernels.offset_groups(offsets if offsets is not None
                                  else [(0, 0, 0)])
    g = k if mode == "lower_bound" else len(glist)
    shape = (f"N={n} M={m} K={k} G={g} {mode}"
             f"{' mult=' + str(tuple(mult)) if mult else ''}")
    if mismatches or not shape_ok:
        raise AssertionError(f"sorted_join {role} {shape}: {mismatches} "
                             "results differ from the twin")
    # the searchsorted yardstick on the same queries, packed beforehand
    offs = torch.tensor(np.asarray(offsets if offsets is not None
                                   else [(0, 0, 0)]), dtype=torch.int32,
                        device=base.device)
    xyz = base[:, :3] * (torch.tensor(mult, dtype=torch.int32,
                                      device=base.device) if mult else 1)
    q = torch.cat([xyz[None] + offs[:, None],
                   base[None, :, 3:].expand(k, -1, -1)], -1)
    q_hi, q_lo = kernels.pack_coords(q.reshape(-1, 4))
    tkey = kernels.key64(table.hi, table.lo)
    qkey = kernels.key64(q_hi, q_lo)
    outs = {"exact": 4 * k * m, "lower_bound": 4 * k * m,
            "window": 4 * k * m + 4 * g * m + k * m}[mode]
    nbytes = 16 * m + outs + (12 if mode == "exact" else 8) * n
    probes = math.ceil(math.log2(n + 1))
    ops = 3.0 * (g * m * probes + k * m)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["int32"] * 1e3
    nq_old = k * m + (g * m if mode == "window" else 0)
    case = {
        "shape": shape, "role": role, "max_abs_err": 0.0,
        "hits": int((got[0] >= 0).sum()) if mode != "lower_bound" else None,
        "ms": cuda_ms(lambda: kernels.sorted_join(*args), iters,
                      f"sorted_join {role}"),
        "plain_ms": cuda_ms(lambda: kernels.sorted_join_plain(*args), iters,
                            f"sorted_join_plain {role}"),
        "library_ms": cuda_ms(lambda: torch.searchsorted(tkey, qkey), iters,
                              f"searchsorted {role}"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_old_ms": ((3 if mode == "exact" else 2) * n * 4
                         + 3 * nq_old * 4) / HBM_BYTES_PER_S * 1e3,
    }
    log(f"sorted_join {role} {shape}: equal to the twin, kernel "
        f"{case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, searchsorted "
        f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}; packed-key bound "
        f"{case['bound_old_ms']:.4f})")
    return case


def _join_adversarial(kernels, C, coords, iters, role):
    """The join at full size on inputs that break the callers' order:
    a shuffled table (non-identity perm), unsorted base rows, padding rows
    in the middle, queries that leave the packable range; each in mode
    exact and window."""
    import torch
    gen = torch.Generator().manual_seed(0)
    m = coords.shape[0]
    offs = C.kernel_offsets_np(3)
    table = C.build_table(coords, assume_sorted=True)
    shuffled = coords[torch.randperm(m, generator=gen).to(coords.device)]
    rows = torch.randint(0, m, (m // 20,), generator=gen).to(coords.device)
    middle = coords.clone()
    middle[rows] = C.INVALID_COORD
    edge = coords.clone()
    half = rows.shape[0] // 2
    edge[rows[:half], 0] = kernels.SPAN_X - kernels.OFFSET_XY - 1
    edge[rows[half:], 2] = -kernels.OFFSET_Z - 1
    cases = []
    for name, tab, base in (
            ("non-identity perm", C.build_table(shuffled), coords),
            ("unsorted base", table, shuffled.contiguous()),
            ("middle sentinels", table, middle),
            ("out of range", table, edge)):
        for mode in ("exact", "window"):
            cases.append(_join_case(kernels, tab, base, offs, mode, iters,
                                    role=f"{role} {name}"))
    return cases


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

    # --- sorted_join: the stem plan's exact join (84,992-row table, 27 x
    # 84,992 queries; the kernels line's case), the seg down plan, the ELK
    # aux window's self-join (r = 2, x-major even taps) and K = 1
    from link_tpu_torch.ops.elk import voxel_to_aux
    table = C.build_table(st.coords, assume_sorted=True)
    res["sorted_join"] = _join_case(kernels, table, st.coords,
                                    C.kernel_offsets_np(3), "exact", iters,
                                    role="seg stem")
    down_c, _ = spdownsample(st.coords, DEFAULT_CAPACITIES[1])
    aux = voxel_to_aux(st, 3, n)[0]
    aux_table = C.build_table(aux.coords, assume_sorted=True)
    res["sorted_join_seg_cases"] = [
        res["sorted_join"],
        _join_case(kernels, table, down_c, C.kernel_offsets_np(2), "exact",
                   iters, role="seg down K=8"),
        _join_case(kernels, aux_table, aux.coords, C.kernel_offsets_np(2),
                   "exact", iters, role="seg ELK aux r=2"),
        _join_case(kernels, table, st.coords, None, "exact", iters,
                   role="seg K=1")]

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
                                rand((27, 64, 64), dtype) * 0.125, iters,
                                "seg K=27 64->64"))
        cases.append(_conv_case(kernels, st.feats.to(dtype), in_idx,
                                rand((27, 4, 64), dtype) * 0.1, iters,
                                "seg stem 4->64"))
        cases.append(_conv_case(kernels, rand((n, 128), dtype), in_idx,
                                rand((27, 128, 64), dtype) * 0.09, iters,
                                "seg decoder 128->64"))
        cases.append(_conv_case(kernels, rand((m_coarse, 64), dtype), inv_idx,
                                rand((8, 64, 64), dtype) * 0.125, iters,
                                "seg K=8 transposed"))
        cases.append(_conv_case(kernels, f64, down.in_idx,
                                rand((8, 64, 64), dtype) * 0.125, iters,
                                "seg K=8 down"))
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
    from link_tpu_torch.utils.timing import events_ms

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
        # the whole forward, plans included, by CUDA events (host and
        # card): least of 3
        res["golden_ms"] = events_ms(lambda: model(st.replace(
            cmaps={st.stride: (st.coords, st.nnz)}, kmaps={})), reps=3)
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


# name stems of the kernels in link_tpu_torch/csrc (`<stem>_kernel`)
HAND_KERNELS = ("sorted_join", "join_pin", "gather_conv", "w_frag", "window_conv",
                "gather_wgrad", "wgrad_reduce", "list_count", "list_scan",
                "list_write", "row_gather", "slab_copy", "empty", "nms_rank",
                "nms_mask", "nms_walk")


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
    # torch.optim wraps each step in its own range ("Optimizer.step#<class>.
    # step"), which the trace also lays on the device's timeline as an
    # annotation spanning the step's kernels: no device work of its own
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges and not e.key.startswith("Optimizer.")]
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
        # every kernel of link_tpu_torch/csrc, however small its share
        "hand_kernels": [{f"ms_per_{unit}": t, f"launches_per_{unit}": c,
                          "name": k[:160]} for t, c, k in by_name
                         if any(f"{fn}_kernel" in k for fn in HAND_KERNELS)],
    }
    from link_tpu_torch.tools.join_sites import range_stats
    for name in ranges:
        out.setdefault("ranges", {})[name] = range_stats(prof, name, n_items)
    if not busy_ms:
        log("profile: no device time in the trace (not measured)")
        return out
    log(f"profile: device busy {busy_ms:.2f} ms per {unit} of {wall_ms:.2f} "
        f"ms wall (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{out[f'launches_per_{unit}']:.0f} kernel launches per {unit} "
        f"of {len(kern)} kinds")
    for t, c, k in by_name[:12]:
        log(f"  {t:8.3f} ms {t / busy_ms:6.1%} x{c:<5d} {k[:90]}")
    for name, r in out.get("ranges", {}).items():
        log(f"  range {name}: {r['sites']:.0f} entered, host "
            f"{r['host_ms']:.3f} ms, device {r['device_ms']:.4f} ms in "
            f"{r['launches']:.0f} launches")
    return out


def _check_join_sites(prof, unit: str, calls: float) -> None:
    """Each join site's profiler range holds its `sorted_join` call and
    nothing else: one kernel launch, two for the window form (the join and
    its pinning), and no PyTorch operation on the card."""
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    r = prof["ranges"][JOIN_RANGE]
    other = {k: v for k, v in r["kinds"].items()
             if "sorted_join_kernel" not in k and "join_pin_kernel" not in k}
    joins = sum(v for k, v in r["kinds"].items() if "sorted_join_kernel" in k)
    if other or joins != calls or r["sites"] != calls:
        raise AssertionError(f"join sites per {unit}: {r['sites']} ranges, "
                             f"{joins} sorted_join launches (expected "
                             f"{calls}), other device work {other}")


def phase_profile(res, ctx):
    """Device time by kernel over one pass of the seg path's scans, and
    the join sites' range."""
    import torch
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    model, scans, fresh = ctx["model"], ctx["scans"], ctx["fresh"]
    with torch.inference_mode():
        inputs = [fresh(st) for st in scans]
        res["profile"] = _profile(lambda: [model(x) for x in inputs],
                                  len(scans), 1e3 / max(res["scans_per_s"]),
                                  "scan", ranges=(JOIN_RANGE,))
    _check_join_sites(res["profile"], "scan",
                      res["launches"]["sorted_join"] / len(scans))


# --------------------------------------------------------------------------
# the other seg families: ELKEncoder, MinkUNet, SPVCNN

FAMILIES = ("linkencoder", "minkunet", "spvcnn")
# the main path's dtype per family: the ELK encoder and MinkUNet in
# bfloat16 as ELKUNet's `main`; SPVCNN has float32 only, as the JAX model
FAMILY_DTYPE = {"linkencoder": "bfloat16", "minkunet": "bfloat16",
                "spvcnn": "float32"}
FAMILY_GOLDEN = {"linkencoder": "elkencoder_cr0.25.npz",
                 "minkunet": "minkunet_cr0.25.npz",
                 "spvcnn": "spvcnn_cr0.25.npz"}
# every U-Net of the families builds 9 conv plans per scan (one join each):
# one submanifold plan at each of the 5 strides and the 4 down convs'
FAMILY_PLANS = 9
# SPVCNN's point joins per scan: voxel_to_point at strides 1, 16 and 4
# (stride 1 again reuses the first), point_to_voxel at strides 16 and 4
# (stride 1 reuses initial_voxelize's map)
SPVCNN_POINT_JOINS = 5


def _family_config(name: str) -> str:
    return os.path.join(HERE, "configs", "semantic_kitti", name,
                        "default.yaml")


def _golden_family_model(name, g, grid_extent=None):
    """The family at the golden's cr with the reference weights, float32,
    at DEFAULT_CAPACITIES on the card: the encoder at the golden's r=3,
    s=5, groups=2, cos (tests/test_golden_parity.py:113-114), SPVCNN on
    integer positions (pres = vres = 1)."""
    import torch
    from link_tpu_torch.models.linkencoder import ELKEncoder
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    from link_tpu_torch.models.minkunet import MinkUNet
    from link_tpu_torch.models.spvcnn import SPVCNN
    from link_tpu_torch.utils.convert import load_reference_state_dict
    kw = dict(cr=float(g["cr"]), capacities=DEFAULT_CAPACITIES,
              device="cuda")
    if name == "linkencoder":
        model = ELKEncoder(20, r=3, s=5, groups=2, baseop="cos",
                           grid_extent=grid_extent, **kw)
    elif name == "minkunet":
        model = MinkUNet(20, **kw)
    else:
        model = SPVCNN(20, pres=1.0, vres=1.0, **kw)
    load_reference_state_dict(model, {
        k[3:].replace("__", "."): torch.from_numpy(np.array(g[k]))
        for k in g.files if k.startswith("sd_")})
    return model.eval()


def _elk_aux_paths(model, ext):
    """Which aux path ("dense" or "sparse") each ELK level of the encoder
    takes on a tensor bounded by `ext` (ops/elk.use_dense_aux)."""
    import torch
    from link_tpu_torch.ops.elk import use_dense_aux
    from link_tpu_torch.sparse.tensor import SparseTensor
    probe = SparseTensor(feats=torch.empty(0, 1),
                         coords=torch.empty(0, 4, dtype=torch.int32),
                         nnz=torch.tensor(0), grid_extent=ext)
    paths = []
    for lvl in range(1, 5):
        block = getattr(model, f"elk{lvl}")
        width = (3 if block.baseop == "cos_x" else 2) * block.inc
        gs = use_dense_aux(probe, (1 << lvl) * model.s, model.r, width)
        paths.append("sparse" if gs is None else "dense")
    return paths


def phase_seg_families_golden(res, ctx):
    """The ELKEncoder, MinkUNet and SPVCNN goldens (reference weights and
    logits, cr 0.25) in float32 on the card at DEFAULT_CAPACITIES; the
    encoder through its sparse aux join and, with a grid extent, its dense
    aux grid."""
    import torch
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    from link_tpu_torch.sparse.coords import INVALID_COORD
    from link_tpu_torch.sparse.tensor import make_sparse_tensor

    errs = {}
    for name in FAMILIES:
        g = np.load(os.path.join(HERE, "tests", "goldens",
                                 FAMILY_GOLDEN[name]))
        coords, feats, want = g["coords"], g["feats"], g["logits"]
        n, cap = len(coords), DEFAULT_CAPACITIES[0]
        cpad = np.full((cap, 4), INVALID_COORD, np.int32)
        fpad = np.zeros((cap, feats.shape[1]), np.float32)
        cpad[:n], fpad[:n] = coords, feats
        ext = tuple(int(v) for v in coords[:, :3].max(0) + 1) + (1,)
        runs = ({"sparse": None, "dense": ext} if name == "linkencoder"
                else {"": None})
        for aux, grid in runs.items():
            model = _golden_family_model(name, g, grid)
            if name == "linkencoder":
                paths = _elk_aux_paths(model, grid)
                if paths != [aux] * 4:
                    raise AssertionError(f"{name} golden: aux paths {paths}")
            st = make_sparse_tensor(fpad, cpad, nnz=n, device="cuda")
            with torch.inference_mode():
                got = model(st)[:n].float().cpu().numpy()
            err = float(np.max(np.abs(got - want))
                        / (np.max(np.abs(want)) + 1e-9))
            label = f"{name} {aux}".strip()
            errs[label] = err
            log(f"golden {label} cr{float(g['cr'])} f32 ({n} voxels): rel "
                f"err {err:.3g} (tol {GOLDEN_REL_TOL})")
            if not np.isfinite(got).all() or not err < GOLDEN_REL_TOL:
                raise AssertionError(f"{label} golden: rel err {err}")
    res["seg_families_golden"] = errs


def _kernel_ms(prof, stems, unit="scan"):
    """Device ms per item of the hand kernels whose names hold one of
    `stems` (`<stem>_kernel`), from a `_profile` result."""
    return sum(k[f"ms_per_{unit}"] for k in prof.get("hand_kernels", [])
               if any(f"{s}_kernel" in k["name"] for s in stems))


def phase_seg_families_main(res, ctx, rounds=3):
    """Each family built by `make_model` from its config at full width and
    depth (cr 1.0), random weights from seed 0, batch 1 on `main`'s scans
    at DEFAULT_CAPACITIES: launch counts around one pass of the scans,
    scans/s (best of 3 rounds), one more pass profiled (device time, idle
    share, the kernels' share) with the join-site check and the join
    inputs' range."""
    import torch
    from link_tpu_torch.data.semantic_kitti import NUM_CLASSES, grid_extent
    from link_tpu_torch.models import builder
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    from link_tpu_torch.nn.modules import SparseConv3d
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse.coords import JOIN_INPUT_RANGE, JOIN_RANGE
    from link_tpu_torch.utils.config import load_config

    scans, fresh = ctx["scans"], ctx["fresh"]
    ext = grid_extent(0.05, batch_size=1)
    res["families"], ctx["families"] = {}, {}
    for name in FAMILIES:
        cfg = load_config(_family_config(name))
        if tuple(cfg.model.capacities) != DEFAULT_CAPACITIES:
            raise AssertionError(f"{name}: the config's capacities changed")
        model = builder.make_model(
            cfg, capacities=DEFAULT_CAPACITIES, dtype=FAMILY_DTYPE[name],
            device="cuda", generator=torch.Generator().manual_seed(0),
            grid_extent=ext)
        model.eval()
        with torch.inference_mode():
            model(fresh(scans[0]))                             # warm-up
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            outs = [model(fresh(st)) for st in scans]
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
            if out.shape != (st.capacity, NUM_CLASSES):
                raise AssertionError(f"{name}: logits {tuple(out.shape)}")
            if not torch.isfinite(out[:int(st.nnz)].float()).all():
                raise AssertionError(f"{name}: non-finite logits")

        n = len(scans)
        aux = _elk_aux_paths(model, ext) if name == "linkencoder" else None
        want_join = FAMILY_PLANS + (
            aux.count("sparse") + 4 if name == "linkencoder"  # + upsample_voxel
            else SPVCNN_POINT_JOINS if name == "spvcnn" else 0)
        want_conv = sum(1 for mod in model.modules()
                        if isinstance(mod, SparseConv3d)
                        and math.prod(mod.kernel_size) > 1)
        scans_per_s = [n / t for t in times]
        with torch.inference_mode():
            inputs = [fresh(st) for st in scans]
            prof = _profile(lambda: [model(x) for x in inputs], n,
                            1e3 / max(scans_per_s), "scan",
                            ranges=(JOIN_RANGE, JOIN_INPUT_RANGE))
        _check_join_sites(prof, "scan", want_join)
        # the new sites form their inputs in PyTorch before the join's
        # range: once per upsample_voxel and per uncached point join
        want_inputs = (4 if name == "linkencoder" else SPVCNN_POINT_JOINS
                       if name == "spvcnn" else 0)
        inputs_range = prof["ranges"][JOIN_INPUT_RANGE]
        if inputs_range["sites"] != want_inputs:
            raise AssertionError(f"{name}: {inputs_range['sites']} join-input "
                                 f"ranges per scan, expected {want_inputs}")
        busy = prof["device_busy_ms_per_scan"]
        conv_ms = _kernel_ms(prof, ("gather_conv", "w_frag"))
        join_ms = _kernel_ms(prof, ("sorted_join",))
        fam = {"dtype": FAMILY_DTYPE[name], "scans_per_s": scans_per_s,
               "launches_per_scan": {k: v / n for k, v in launches.items()},
               "profile": prof, "gather_conv_ms_per_scan": conv_ms,
               "gather_conv_share": conv_ms / busy if busy else None,
               "sorted_join_ms_per_scan": join_ms,
               "join_inputs_per_scan": inputs_range, "elk_aux_paths": aux,
               "params": sum(p.numel() for p in model.parameters())}
        res["families"][name] = fam
        res[f"family_launches_{name}"] = launches
        log(f"{name} {FAMILY_DTYPE[name]} cr1.0, {n} scans: launches per "
            f"scan gather_conv {launches['gather_conv'] / n:.0f} (expected "
            f"{want_conv}), sorted_join {launches['sorted_join'] / n:.0f} "
            f"(expected {want_join}); scans/s per round "
            f"{[round(v, 3) for v in scans_per_s]}; gather_conv "
            f"{conv_ms:.3f} ms per scan, sorted_join {join_ms:.4f} ms"
            + (f"; join inputs formed in PyTorch {inputs_range['device_ms']:.4f}"
               f" ms in {inputs_range['launches']:.0f} launches"
               if want_inputs else "")
            + (f"; ELK aux paths by level {aux}" if aux else ""))
        if (launches["gather_conv"] != n * want_conv
                or launches["sorted_join"] != n * want_join):
            raise AssertionError(f"{name}: launch counts {launches} differ "
                                 f"from the expected {want_conv} convs and "
                                 f"{want_join} joins per scan")
        ctx["families"][name] = (cfg, model)


def phase_seg_families_hold(res, ctx):
    """Each family at cr 1.0 in float32 with the weights of seed 0, on
    `main`'s scan 0: the card (kernels) against the CPU (plain twins)."""
    import torch
    from link_tpu_torch.data.semantic_kitti import grid_extent
    from link_tpu_torch.models import builder
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES

    ext = grid_extent(0.05, batch_size=1)
    scan = {dev: _scan_tensor(0, dev) for dev in ("cuda", "cpu")}
    n = int(scan["cpu"].nnz)
    out = {}
    for name in FAMILIES:
        cfg = ctx["families"][name][0]
        logits = {}
        for dev in ("cuda", "cpu"):
            model = builder.make_model(
                cfg, capacities=DEFAULT_CAPACITIES, dtype="float32",
                device=dev, generator=torch.Generator().manual_seed(0),
                grid_extent=ext).eval()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits[dev] = model(scan[dev])[:n].cpu()
            if dev == "cpu":
                cpu_s = time.perf_counter() - t0
        err = rel_err(logits["cuda"], logits["cpu"])
        out[name] = {"rel_err": err, "cpu_s": cpu_s, "voxels": n}
        log(f"hold {name} cr1.0 f32, card vs CPU on {n} voxels: rel err "
            f"{err:.3g} (tol {GOLDEN_REL_TOL}); CPU forward {cpu_s:.1f} s")
        if not torch.isfinite(logits["cuda"]).all() or not err < GOLDEN_REL_TOL:
            raise AssertionError(f"{name}: card vs CPU rel err {err}")
    res["seg_families_hold"] = out


def phase_seg_families_eval(res, ctx):
    """`link_tpu_torch.tools.seg_evaluate` on the card for each family: a
    checkpoint of the seed-0 model of `seg_families_main`, the synthetic
    val split, 2 scans, at the config's capacities x 1.6."""
    import tempfile
    from link_tpu_torch.models import builder
    from link_tpu_torch.tools import seg_evaluate
    from link_tpu_torch.train.checkpoint import save_checkpoint
    from link_tpu_torch.train.trainer import TrainState

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FAMILIES:
            cfg, model = ctx["families"][name]
            ckpt = save_checkpoint(
                os.path.join(tmp, name), TrainState(model, builder.make_optimizer(
                    cfg, model.parameters(), 0.0)), 0)
            r = seg_evaluate.evaluate(seg_evaluate.parse_args(
                [_family_config(name), ckpt, "--synthetic", "--limit", "2"]))
            out[name] = {k: r[k] for k in ("miou", "ms_per_scan", "scans",
                                           "overflow_scans", "overflow")}
            log(f"seg_evaluate {name}: point-level mIoU {r['miou']:.4f} at "
                f"random weights, ms per scan {[round(v, 1) for v in r['ms_per_scan']]}")
            if r["scans"] != 2 or not 0 <= r["miou"] <= 1:
                raise AssertionError(f"seg_evaluate {name}: {r}")
    res["seg_families_eval"] = out


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
    """window_conv vs its twin on one plan: error, two runs bit-equal,
    times, bound, and `gather_conv` on the same plan's kernel map, weights
    and dtype as the sibling yardstick (`sibling_ms`)."""
    import torch
    args = (feats, plan.base_pos, plan.slot, plan.groups, weight)
    in_idx = getattr(plan, "in_idx", None)
    got = kernels.window_conv(*args)
    again = kernels.window_conv(*args)
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
    t_ops = ops / TC_OPS[dt] * 1e3
    window = getattr(plan, "window", None)
    shape = (f"{'N=M=' + str(m) if n == m else f'N={n} M={m}'} "
             f"{f'Gg={gg}' if window is None else f'G={window}'} K={k} "
             f"Ci={ci} Co={co} {dt}")
    case = {
        "shape": shape,
        "rel_err": err, "tol": tol,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "same_twice": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: kernels.window_conv(*args), iters,
                      f"window_conv {shape}"),
        "plain_ms": cuda_ms(lambda: kernels.window_conv_plain(*args), iters,
                            f"window_conv_plain {shape}"),
        "sibling_ms": None if in_idx is None else cuda_ms(
            lambda: kernels.gather_conv(feats, in_idx, weight), iters,
            f"gather_conv on the window plan {shape}"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "hits": hits,
    }
    sibling = ("" if in_idx is None else
               f", gather_conv on the plan {case['sibling_ms']:.4f} ms")
    log(f"window_conv {shape}: rel err {err:.3g} (tol {tol}), same twice "
        f"{case['same_twice']}, kernel {case['ms']:.4f} ms, twin "
        f"{case['plain_ms']:.4f} ms{sibling}, bound {case['bound_ms']:.4f} "
        f"ms ({case['bound_by']}), hits {hits}")
    if not err < tol:
        raise AssertionError(f"window_conv {shape}: rel err {err} >= {tol}")
    if not case["same_twice"]:
        raise AssertionError(f"window_conv {shape}: two runs differ")
    return case


def phase_det_kernels(res, ctx, iters=20):
    import torch
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse import coords as C
    from link_tpu_torch.sparse.conv import add_window_form, build_conv_plan
    from link_tpu_torch.sparse.spconv_engine import (
        _tap_offsets as _spconv_taps, spconv_downsample, spconv_out_shape)
    from link_tpu_torch.models.scn import DET_CAPACITIES

    dev = torch.device("cuda")
    _, batch = _det_frame(0)
    coords = torch.from_numpy(batch["coords"]).to(dev)
    nnz = torch.tensor(int(batch["nnz"]), dtype=torch.int32, device=dev)
    n = coords.shape[0]
    log(f"det kernel inputs: frame 0, {int(batch['nnz'])} voxels in {n} rows")
    offs = C.kernel_offsets_np(3)

    # --- sorted_join on the 163,840-row level-0 table: the SubM plan's
    # window join (27 taps in 9 groups, the det main path's), its exact
    # join and its 9 group anchors' lower bounds (the pair the window join
    # replaced), and the adversarial inputs at full size
    table = C.build_table(coords, assume_sorted=True)
    anchors = [a for a, _ in C.offset_groups(offs)]
    res["sorted_join_det_window"] = _join_case(
        kernels, table, coords, offs, "window", iters, role="det level 0")
    res["sorted_join_det_exact"] = _join_case(
        kernels, table, coords, offs, "exact", iters, role="det level 0")
    res["sorted_join_lower_bound"] = _join_case(
        kernels, table, coords, anchors, "lower_bound", iters,
        role="det level 0 anchors")
    res["sorted_join_adversarial"] = _join_adversarial(
        kernels, C, coords, iters, "det level 0")

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
    # the level-1 plan's window join, and the down plan into level 1: base
    # j * 2 formed in the kernel, taps t - p
    down_taps = _spconv_taps((3, 3, 3)) - np.array([1, 1, 1], np.int32)
    res["sorted_join_det_plans"] = [
        _join_case(kernels, table1, c1, offs, "window", iters,
                   role="det level 1"),
        _join_case(kernels, table, c1, down_taps, "exact", iters,
                   mult=(2, 2, 2), role="det down 0->1")]
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
    # level 0 with its last 5 output rows cut: M not a multiple of 16, so
    # the kernel reads the tile's base rows and slots by plain loads and
    # writes a ragged last tile
    m = plan0.slot.shape[1] - 5
    ragged = plan0.replace(base_pos=plan0.base_pos[:, :m].contiguous(),
                           slot=plan0.slot[:, :m].contiguous(),
                           in_idx=plan0.in_idx[:, :m].contiguous())
    cases.append(_window_case(kernels, rand((m + 5, 16), torch.float32),
                              ragged, rand((27, 16, 16), torch.float32,
                                           (16 * 27) ** -0.5), iters))
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


def phase_det_elk_golden(res, ctx):
    """The reference TSELKBlock golden at the det capacity (160,000 voxels
    in 163,840 rows; cos basis, det channel grouping, r = 3) in float32 on
    the card, through the sparse aux path (its window join through
    `sorted_join` at real spans) and the dense one, against the reference
    output, held as tests/test_torch_join_sites.py holds it on the CPU."""
    import torch
    from link_tpu_torch.models.elk import ELKBlock
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.ops.elk import use_dense_aux
    from link_tpu_torch.sparse.coords import INVALID_COORD
    from link_tpu_torch.sparse.tensor import make_sparse_tensor

    g = np.load(TSELK_GOLDEN)
    coords, feats, want = g["coords"], g["feats"], g["out"]
    inc, block_sz = int(g["inc"]), int(g["block_sz"])
    n, cap = len(coords), 163840
    cpad = np.full((cap, 4), INVALID_COORD, np.int32)
    fpad = np.zeros((cap, inc), np.float32)
    cpad[:n], fpad[:n] = coords, feats
    block = ELKBlock(inc, aux_capacity=cap, baseop="cos", det_grouping=True,
                     device="cuda")
    block.load_state_dict({k[3:].replace("__", "."): torch.from_numpy(
        np.array(g[k])) for k in g.files if k.startswith("sd_")}, strict=True)
    errs = {}
    for path in ("sparse", "dense"):
        ext = None
        if path == "dense":
            ext = tuple(int(v) for v in coords[:, :3].max(0) + 1) + (
                int(coords[:, 3].max()) + 1,)
        st = make_sparse_tensor(fpad, cpad, nnz=n, grid_extent=ext,
                                device="cuda")
        if (use_dense_aux(st, block_sz, 3, 2 * inc) is not None) != (
                path == "dense"):
            raise AssertionError(f"tselk: the {path} aux path was not taken")
        before = kernels.sorted_join.launches
        with torch.inference_mode():
            got = block(st, block_sz, 3).feats[:n].float().cpu().numpy()
        joins = kernels.sorted_join.launches - before
        errs[path] = float(np.abs(got - want).max()
                           / (np.abs(want).max() + 1e-9))
        log(f"tselk full-scale golden, {path} aux path: rel err "
            f"{errs[path]:.3g} (tol {GOLDEN_REL_TOL}); {joins} sorted_join "
            "launches")
        if not np.isfinite(got).all() or not errs[path] < GOLDEN_REL_TOL:
            raise AssertionError(f"tselk {path}: rel err {errs[path]}")
        if path == "sparse" and joins < 2:
            raise AssertionError("tselk sparse path: the joins did not run "
                                 "through sorted_join")
    res["tselk_golden_rel_err"] = errs


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
    # 4 SubM levels (one window join each: the kernel map and its window
    # form), 3 downs and the extra conv (one exact join each)
    plans = 4 + 4
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
    ctx.update(pred=pred, det_batches=batches,
               det_points=[p for p, _ in frames])


def phase_det_profile(res, ctx):
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    pred, batches = ctx["pred"], ctx["det_batches"]
    res["det_profile"] = _profile(
        lambda: [pred.forward(b) for b in batches], len(batches),
        1e3 / max(res["det_frames_per_s"]), "frame", ranges=(JOIN_RANGE,))
    _check_join_sites(res["det_profile"], "frame",
                      res["det_launches"]["sorted_join"] / len(batches))


# --------------------------------------------------------------------------
# detection serving: NMS on the device, and the host side

NEAR_THRESH = 1e-5    # a pair whose IoU lies this close to the threshold may
#                       be decided either way by two IoU routines of other
#                       precisions (the kernel's clip in float64, the twin's
#                       24-candidate hull in float32 about the pair's first
#                       centre; on the H100 the two agree within 5e-7 over
#                       every case of det_nms_kernels)
NATIVE_IOU_TOL = 1e-6  # the kernel's IoU against the native library's clip
#                       (the same float64 algorithm, returned in float32)
NMS_PAIR_OPS = 10     # operations of one circumscribed-circle test
NMS_CLIP_OPS = 150    # operations of one clip of two quads and its area
#                       (4 clip edges over 4-8 vertices, the crossings, the
#                       shoelace): a lower count than the kernel's


def _nms_inputs(n: int, seed: int, dev):
    """A synthetic candidate set: boxes packed so that many overlap, every
    7th a copy of its neighbour, every 11th of zero width; bf16-quantized
    scores (heavy ties); a fifth of the rows and rows 10-19 invalid."""
    import torch
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 5), np.float32)
    spread = 0.8 * math.sqrt(n) + 1
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 3.0, (n, 2))
    b[:, 4] = rng.uniform(-math.pi, math.pi, n)
    b[1::7] = b[0::7][:len(b[1::7])]
    b[2::11, 2] = 0
    logits = torch.tensor(rng.integers(-6, 6, n) / 4.0,
                          dtype=torch.bfloat16).float()
    valid = rng.random(n) > 0.2
    valid[10:20] = False
    return (torch.from_numpy(b).to(dev), torch.sigmoid(logits).to(dev),
            torch.from_numpy(valid).to(dev))


def _nms_bound(boxes, valid):
    """The least time of rotated NMS on this run's data, one set (N, 5) or
    S sets (S, N, 5): bytes of boxes, scores, valid and keep once at the
    HBM rate against NMS_PAIR_OPS per valid pair and NMS_CLIP_OPS per valid
    pair whose circumscribed circles meet (each unordered pair once) at the
    float32 CUDA-core rate; the larger, what bounds it, and the counts."""
    import torch
    boxes = boxes.reshape(-1, *boxes.shape[-2:])
    valid = valid.reshape(-1, valid.shape[-1])
    sets, n = valid.shape
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    pairs = clips = 0
    for b, v in zip(boxes, valid):
        both = v[:, None] & v[None, :] & ~eye
        ctr = b[:, :2].double()
        rad = 0.5 * torch.hypot(b[:, 2].double(), b[:, 3].double())
        meet = torch.cdist(ctr, ctr) <= rad[:, None] + rad[None, :]
        pairs += int(both.sum()) // 2
        clips += int((both & meet).sum()) // 2
    t_bytes = sets * n * (5 * 4 + 4 + 1 + 1) / HBM_BYTES_PER_S * 1e3
    t_ops = (NMS_PAIR_OPS * pairs + NMS_CLIP_OPS * clips) \
        / PEAK_OPS["float32"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", pairs, clips)


def _nms_case(kernels, nms, native, boxes, scores, valid, thresh, max_keep,
              role):
    """rotated_nms against its twin on one candidate set, as a singleton
    call. The kernel's IoU (`rotated_nms_iou`, its tile code) must lie
    within NATIVE_IOU_TOL of the native library's `bev_iou` on every valid
    pair; the kernel's keep must equal the twin's walk over the kernel's
    own overlaps, and each pair the kernel and the twin decide differently
    must lie within NEAR_THRESH of the threshold; then the keep masks are
    equal unless such a pair exists. The kernel's build that sends every
    clipped pair through its overflow redo (`rotated_nms_clip_redo`) must
    keep the same rows, its IoU within NATIVE_IOU_TOL of this build's.
    Returns (the case, the keep)."""
    import torch
    n = scores.shape[0]
    keep = kernels.rotated_nms(boxes, scores, valid, thresh, max_keep)
    twin = nms.rotate_nms_device(boxes, scores, valid, thresh, max_keep)
    redo = kernels.rotated_nms_clip_redo(boxes, scores, valid, thresh,
                                         max_keep)
    iou_k = kernels.rotated_nms_iou(boxes)
    iou_redo = kernels.rotated_nms_iou(boxes, clip_redo=True)
    iou_t = nms.rotated_iou_bev(boxes).double()
    b7 = torch.zeros((n, 7))
    b7[:, [0, 1, 3, 4, 6]] = boxes.cpu()
    b7[:, 5] = 1.0
    iou_n = torch.from_numpy(native.bev_iou(b7.numpy(), b7.numpy())).to(
        boxes.device, torch.float64)
    th = float(np.float32(thresh))          # the kernel compares in float64
    both = (valid[:, None] & valid[None, :]
            & ~torch.eye(n, dtype=torch.bool, device=boxes.device))
    native_diff = float((iou_k - iou_n)[both].abs().max()) \
        if bool(both.any()) else 0.0
    over_k = iou_k > th
    walk = nms.nms_keep(over_k, scores, valid, max_keep)
    near = both & ((iou_t - th).abs() < NEAR_THRESH)
    flips = both & (over_k != (iou_t > th))
    torch.cuda.synchronize()
    shape = f"N={n} thresh={thresh} max_keep={max_keep}"
    case = {
        "role": role, "shape": shape, "kept": int(keep.sum()),
        "kept_twin": int(twin.sum()),
        "keep_diff": int((keep != twin).sum()),
        "max_abs_err": float((keep != twin).any()),
        "near_pairs": int(near.sum()) // 2, "over_flips": int(flips.sum()),
        "max_iou_diff": float((iou_k - iou_t)[both].abs().max())
        if bool(both.any()) else 0.0,
        "max_native_iou_diff": native_diff,
        "redo_keep_equal": bool(torch.equal(redo, keep)),
        "redo_max_iou_diff": float((iou_redo - iou_k)[both].abs().max())
        if bool(both.any()) else 0.0,
    }
    if not (case["redo_keep_equal"]
            and case["redo_max_iou_diff"] <= NATIVE_IOU_TOL):
        raise AssertionError(f"rotated_nms {role} {shape}: the clip-redo "
                             "build keeps other rows (or its IoU is "
                             f"{case['redo_max_iou_diff']:.3g} away)")
    if native_diff > NATIVE_IOU_TOL:
        raise AssertionError(f"rotated_nms {role} {shape}: the kernel's IoU "
                             f"is {native_diff:.3g} from native.bev_iou")
    if not torch.equal(keep, walk):
        raise AssertionError(f"rotated_nms {role} {shape}: the keep differs "
                             "from the walk over the kernel's overlaps")
    if bool((flips & ~near).any()):
        raise AssertionError(f"rotated_nms {role} {shape}: "
                             f"{int((flips & ~near).sum())} pairs decided "
                             "differently from the twin, away from the "
                             "threshold")
    if case["keep_diff"] and not case["over_flips"]:
        raise AssertionError(f"rotated_nms {role} {shape}: keep differs "
                             "from the twin")
    return case, keep


def _nms_batch(kernels, boxes, scores, valid, thresh, max_keep, singles,
               role):
    """One batched rotated_nms call over S sets of one N: each set's keep
    must equal its singleton call's (`singles`, (S, N), or of its first
    columns where a set was padded with invalid rows to the batch's N)."""
    import torch
    keep = kernels.rotated_nms(boxes, scores, valid, thresh, max_keep)
    for s, single in enumerate(singles):
        n = single.shape[0]
        if not (torch.equal(keep[s, :n], single)
                and not bool(keep[s, n:].any())):
            raise AssertionError(f"rotated_nms {role}, set {s} of "
                                 f"{len(singles)}: the batched call's keep "
                                 "differs from the singleton call's")
    return {"role": role, "sets": len(singles), "n": int(scores.shape[1]),
            "thresh": thresh, "max_keep": max_keep,
            "kept": [int(k.sum()) for k in keep]}


def _pad_set(boxes, scores, valid, n):
    """A candidate set padded with invalid rows to n."""
    import torch
    m = scores.shape[0]
    return (torch.cat([boxes, boxes.new_zeros((n - m, 5))]),
            torch.cat([scores, scores.new_zeros(n - m)]),
            torch.cat([valid, valid.new_zeros(n - m)]))


def _nms_frame_timing(kernels, nms, boxes, scores, valid, thresh, max_keep,
                      iters=20):
    """The frame's batched call (S sets) on the card: its time by graph
    replay and each of its three launches' device time from a trace of the
    real calls (`tools/nms_frame.frame_nms_timing`, which nms_frame.py
    times for two checkouts), the batched twin, the empty launch
    (`probe_empty`, the launch floor's unit), and the bound from this run's
    data; max_abs_err is 1 where the call's keep differs from the batched
    twin's (only a pair within NEAR_THRESH of the threshold may make it
    so: `_nms_case`)."""
    import torch
    from link_tpu_torch.tools.nms_frame import frame_nms_timing
    call = kernels.rotated_nms(boxes, scores, valid, thresh, max_keep)
    twin = nms.rotate_nms_device(boxes, scores, valid, thresh, max_keep)
    torch.cuda.synchronize()
    shape = (f"S={scores.shape[0]} N={scores.shape[1]} thresh={thresh} "
             f"max_keep={max_keep}")
    timing = frame_nms_timing(kernels, (boxes, scores, valid), thresh,
                              max_keep, iters=iters)
    if timing["timed_by"] != "graph":
        CAPTURE_FAILED.append(f"rotated_nms {shape}: {timing['timed_by']}")
    names = ["ranks", "mask", "walk"]
    stems = ["nms_rank_kernel", "nms_mask_kernel", "nms_walk_kernel"]
    per_kernel = [[ms for k, ms in timing["kernel_ms"].items() if stem in k]
                  for stem in stems]
    if any(len(p) != 1 for p in per_kernel):
        raise AssertionError(f"rotated_nms {shape}: the trace of the call "
                             "does not hold each of its launches: "
                             f"{timing['kernel_launches']}")
    bound, by, pairs, clips = _nms_bound(boxes, valid)
    empty = torch.zeros((8, 128), device=boxes.device)
    t = {"shape": shape, "launch_names": names,
         "max_abs_err": float((call != twin).any()), "ms": timing["ms"],
         "launch_ms": [p[0] for p in per_kernel],
         "traced_launches_per_call": timing["kernel_launches"]}
    t["plain_ms"] = cuda_ms(lambda: nms.rotate_nms_device(
        boxes, scores, valid, thresh, max_keep), 2,
        f"rotate_nms_device {shape}")
    t["empty_launch_ms"] = cuda_ms(lambda: kernels.probe_empty(empty), iters,
                                   "probe_empty")
    t["launch_floor_ms"] = kernels.ROTATED_NMS_LAUNCHES \
        * t["empty_launch_ms"]
    t.update(bound_ms=bound, bound_by=by, library_ms=None,
             valid_pairs=pairs, clipped_pairs=clips)
    log(f"rotated_nms frame call {shape}: {t['ms']:.4f} ms (launches "
        + ", ".join(f"{a} {b:.4f}" for a, b in zip(t["launch_names"],
                                                   t["launch_ms"]))
        + f"), twin {t['plain_ms']:.4f} ms, bound {bound:.6f} ms ({by}: "
        f"{pairs} valid pairs, {clips} clipped), launch floor "
        f"{t['launch_floor_ms']:.4f} ms ({kernels.ROTATED_NMS_LAUNCHES} x "
        f"{t['empty_launch_ms']:.4f}); library: none")
    return t


def phase_det_nms_kernels(res, ctx):
    """`rotated_nms` against its twin on the card: the real candidates of
    the det frames (6 tasks per frame, the top 1,000 by masked score, the
    config's threshold 0.2 and cap 83), then synthetic sets of N = 1, 63,
    64, 65 and 1,000 (identical, zero-width and invalid rows, tied scores)
    at thresholds 0.01, 0.2 and 0.5 with max_keep 83 and N, and an
    all-invalid set: each as a singleton call against the twin, then as a
    set of one batched call (a frame's six tasks; the synthetic sets of one
    threshold and cap, padded with invalid rows to N = 1,000, max_keep N as
    1,000) against its singleton call. Then the frame's batched call timed,
    whole and launch by launch, beside the twin and the bound."""
    import torch
    from link_tpu_torch import native
    from link_tpu_torch.models.center_head import nms_candidates
    from link_tpu_torch.ops import kernels, nms

    pred = ctx["pred"]
    th, post = pred.cfg["nms_iou_threshold"], pred.cfg["nms_post_max_size"]
    cases, batches, frames = [], [], []
    for f, batch in enumerate(ctx["det_batches"]):
        cands = nms_candidates(pred.forward(batch), pred.cfg)
        bev = torch.cat([bx[:, :, [0, 1, 3, 4, 8]] for bx, *_ in cands])
        sc = torch.cat([c[1] for c in cands])
        vm = torch.cat([c[3] for c in cands])
        singles = []
        for t in range(len(cands)):
            case, keep = _nms_case(kernels, nms, native, bev[t], sc[t],
                                   vm[t], th, post, f"frame {f} task {t}")
            cases.append(case)
            singles.append(keep)
        batches.append(_nms_batch(kernels, bev, sc, vm, th, post, singles,
                                  f"frame {f}, its {len(cands)} tasks"))
        frames.append((bev, sc, vm))
    dev = torch.device("cuda")
    sets = {n: _nms_inputs(n, n, dev) for n in (1, 63, 64, 65, 1000)}
    invalid = _nms_inputs(65, 7, dev)[:2] + (
        torch.zeros(65, dtype=torch.bool, device=dev),)
    for thresh in (0.01, 0.2, 0.5):
        for cap in (83, None):
            group = []
            for n, (boxes, scores, valid) in sets.items():
                case, keep = _nms_case(kernels, nms, native, boxes, scores,
                                       valid, thresh, cap or n, "synthetic")
                cases.append(case)
                group.append(((boxes, scores, valid), keep))
            if thresh == 0.2 and cap == 83:
                case, keep = _nms_case(kernels, nms, native, *invalid, 0.2,
                                       83, "all invalid")
                cases.append(case)
                group.append((invalid, keep))
            padded = [_pad_set(*inp, 1000) for inp, _ in group]
            batches.append(_nms_batch(
                kernels, *(torch.stack(x) for x in zip(*padded)), thresh,
                cap or 1000, [keep for _, keep in group],
                f"synthetic, thresh {thresh}, max_keep {cap or 'N'}"))
    res["rotated_nms_cases"] = cases
    res["rotated_nms_batches"] = batches
    res["rotated_nms_case"] = dict(
        _nms_frame_timing(kernels, nms, *frames[0], th, post),
        role=f"frame 0, its {len(frames[0][1])} tasks in one call")
    real = [c for c in cases if c["role"].startswith("frame")]
    log(f"rotated_nms: {len(cases)} cases, keep masks equal to the twin's in "
        f"{sum(not c['keep_diff'] for c in cases)}; {len(batches)} batched "
        f"calls over {sum(b['sets'] for b in batches)} sets, each equal to "
        f"its singleton calls; pairs within {NEAR_THRESH} of the threshold: "
        f"{sum(c['near_pairs'] for c in cases)}, decided differently: "
        f"{sum(c['over_flips'] for c in cases) // 2}; largest IoU difference "
        f"{max(c['max_iou_diff'] for c in cases):.3g} from the twin, "
        f"{max(c['max_native_iou_diff'] for c in cases):.3g} from "
        f"native.bev_iou; real candidates kept "
        f"{[c['kept'] for c in real]}; the clip-redo build kept the same "
        f"rows in all {len(cases)} cases, its IoU at most "
        f"{max(c['redo_max_iou_diff'] for c in cases):.3g} from this "
        "build's")


@contextlib.contextmanager
def user_tf32():
    """PyTorch's own TF32 flags, as a user's process has them (cuDNN's
    float32 convolutions on TF32), in place of the TF32-free float32 that
    main() sets for the parity gates."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = USER_TF32["matmul"]
    torch.backends.cudnn.allow_tf32 = USER_TF32["cudnn"]
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_det_serve(res, ctx, rounds=2):
    """The det serving path end to end at full width, under a user's TF32
    flags (`user_tf32`): `predict` per frame with host native NMS and with
    device NMS (the `rotated_nms` kernel), each split into voxelize,
    forward + decode (+ device NMS), copies to the host, host NMS and
    floors; the launch counts of one device-NMS pass over the frames; both
    modes' kept boxes from the same decode outputs; and `stream_inference
    --synthetic 3 --device-nms` on the card."""
    with user_tf32():
        _det_serve(res, ctx, rounds)


def _det_serve(res, ctx, rounds):
    import torch
    from link_tpu_torch.models.center_head import device_nms, nms_candidates
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.tools import stream_inference
    from link_tpu_torch.tools.serve_split import split_frame

    host = ctx["pred"]
    dev = copy.copy(host)               # the same model, with device NMS
    dev.device_nms = True
    frames = ctx["det_points"]
    dev.predict(frames[0])                                    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for points in frames:
        dev.predict(points)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    res["det_serve_launches"] = launches
    # one rotated_nms call per frame, over every task
    want = len(frames) * kernels.ROTATED_NMS_LAUNCHES
    log(f"det serve, device NMS, {len(frames)} frames: launches per frame "
        f"{ {k: v / len(frames) for k, v in launches.items() if v} }")
    if launches["rotated_nms"] != want or min(
            launches[k] for k in ("sorted_join", "window_conv",
                                  "gather_conv")) == 0:
        raise AssertionError(f"det serve launches {launches}: expected "
                             f"rotated_nms {want} and every det kernel")

    split = {"host": [], "device": []}
    for _ in range(rounds):
        for mode, pred in (("host", host), ("device", dev)):
            for points in frames:
                det, sp = split_frame(pred, points)
                split[mode].append(sp)
                if not (np.isfinite(det["box3d_lidar"]).all()
                        and np.isfinite(det["scores"]).all()):
                    raise AssertionError(f"{mode}: non-finite detections")
    res["det_serve_split"] = split
    for mode in split:
        med = {k: float(np.median([sp[k] for sp in split[mode]]))
               for k in split[mode][0]}
        res.setdefault("det_serve_median", {})[mode] = med
        log(f"det serve, {mode} NMS, median ms per frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
            + f" (predict, all: "
            f"{[round(sp['predict_ms'], 2) for sp in split[mode]]})")

    th = host.cfg["nms_iou_threshold"]
    compare = []
    for f, batch in enumerate(ctx["det_batches"]):
        outs = host.forward(batch)
        got_h = host.postprocess(outs)
        got_d = dev.postprocess(device_nms(outs, dev.cfg))
        same = all(np.array_equal(got_h[k], got_d[k]) for k in got_h)
        near = _near_pairs(kernels, nms_candidates(outs, host.cfg), th)
        compare.append({"frame": f, "kept_host": len(got_h["scores"]),
                        "kept_device": len(got_d["scores"]), "equal": same,
                        "near_pairs": near})
        if not same and near == 0:
            raise AssertionError(f"frame {f}: host and device NMS keep "
                                 "different boxes, and no pair lies near "
                                 "the threshold")
    res["det_serve_compare"] = compare
    log(f"det serve, host vs device NMS on the same decode outputs: "
        f"{compare}")

    out = os.path.join(HERE, "chiprun_out", "stream_inference.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    stream_inference.main(["--synthetic", "3", "--device-nms", "--out", out])
    with open(out) as fh:
        recs = [json.loads(line) for line in fh]
    res["stream_inference"] = {
        "s": time.perf_counter() - t0, "records": len(recs),
        "latency_ms": [r["latency_ms"] for r in recs],
        "boxes": [len(r["boxes"]) for r in recs]}
    log(f"stream_inference --synthetic 3 --device-nms: "
        f"{res['stream_inference']}")
    if (len(recs) != 3 or any(len(r["boxes"]) != len(r["scores"])
                              or not np.isfinite(r["scores"]).all()
                              for r in recs)):
        raise AssertionError(f"stream_inference records: {recs[:1]}")


# --------------------------------------------------------------------------
# det on nuScenes-format files: double-flip and rotation TTA

DET_FLIP_GOLDEN = os.path.join(HERE, "tests", "goldens", "det_flip.npz")
# the golden's decode (tests/test_golden_det_dense.py:50-90): six tasks,
# a near-zero NMS radius in the reference, so its rows are the decode's
FLIP_TEST_CFG = dict(post_center_limit_range=[-8.0, -8.0, -10.0,
                                              8.0, 8.0, 10.0],
                     score_threshold=0.4, pc_range=[-6.0, -6.0],
                     voxel_size=[0.075, 0.075], out_size_factor=8)
FLIP_NUM_CLASSES = (1, 2, 2, 1, 2, 2)
FLIP_BOX_RTOL, FLIP_BOX_ATOL = 1e-4, 1e-5   # as the JAX golden test
FLIP_SCORE_RTOL = 1e-5
# nuScenes-format files of write_synthetic_infos: keyframes per split (the
# first of each split has no previous sweep), 10 sweeps, 200k points a frame
NUS_TREE = {"train": 2, "val": 3}
NUS_SWEEPS = 10
DET_FILES_LOG = os.path.join(HERE, "chiprun_out", "det_files.log")


def _flip_decode(z, device):
    """double_flip_fuse + decode_boxes(double_flip=True) of the golden's
    maps on `device`: each task's rows above the threshold, by descending
    score (the reference's circle NMS emits them so), concatenated."""
    import torch
    from link_tpu_torch.models.center_head import decode_boxes
    preds = [{k: torch.from_numpy(np.ascontiguousarray(np.transpose(
        z[f"flip_t{t}_{k}"], (0, 2, 3, 1)))).to(device)
        for k in ("hm", "reg", "height", "dim", "rot", "vel")}
        for t in range(len(FLIP_NUM_CLASSES))]
    outs = decode_boxes(preds, FLIP_TEST_CFG, FLIP_NUM_CLASSES,
                        double_flip=True)
    rows = ([], [], [])
    for bx, sc, lb, mk in outs:
        m = mk[0].cpu().numpy()
        b, s, lab = (bx[0].cpu().numpy()[m], sc[0].cpu().numpy()[m],
                     lb[0].cpu().numpy()[m])
        order = np.argsort(-s, kind="stable")
        for dst, src in zip(rows, (b, s, lab)):
            dst.append(src[order])
    return tuple(np.concatenate(r) for r in rows)


def phase_det_flip_golden(res, ctx):
    """The double-flip fuse and decode on the card against the reference's
    (tests/goldens/det_flip.npz: boxes rtol 1e-4 / atol 1e-5, scores rtol
    1e-5, labels exact), and the same maps on the card against the CPU."""
    import torch
    z = np.load(DET_FLIP_GOLDEN)
    got = _flip_decode(z, "cuda")
    cpu = _flip_decode(z, "cpu")
    want = (z["flip_boxes"], z["flip_scores"], z["flip_labels"])
    out = {"rows": len(got[1]), "golden_rows": len(want[1])}
    for name, ref in (("golden", want), ("cpu", cpu)):
        if got[0].shape != ref[0].shape or not np.array_equal(got[2],
                                                              ref[2]):
            raise AssertionError(f"det_flip_golden: rows {got[0].shape} and "
                                 f"labels against the {name}'s "
                                 f"{ref[0].shape} differ")
        out[f"{name}_box_abs_err"] = float(np.abs(got[0] - ref[0]).max())
        out[f"{name}_score_rel_err"] = float(
            (np.abs(got[1] - ref[1]) / np.abs(ref[1])).max())
    out["cpu_box_rel_err"] = rel_err(torch.from_numpy(got[0]),
                                     torch.from_numpy(cpu[0]))
    res["det_flip_golden"] = out
    log(f"det_flip_golden: {out['rows']} rows, labels equal; boxes "
        f"{out['golden_box_abs_err']:.3g} abs from the golden (rtol "
        f"{FLIP_BOX_RTOL}, atol {FLIP_BOX_ATOL}), scores "
        f"{out['golden_score_rel_err']:.3g} rel (rtol {FLIP_SCORE_RTOL}); "
        f"card vs CPU boxes {out['cpu_box_rel_err']:.3g} rel, scores "
        f"{out['cpu_score_rel_err']:.3g} rel")
    if not (np.allclose(got[0], want[0], rtol=FLIP_BOX_RTOL,
                        atol=FLIP_BOX_ATOL)
            and np.allclose(got[1], want[1], rtol=FLIP_SCORE_RTOL, atol=0)):
        raise AssertionError(f"det_flip_golden: off the golden: {out}")
    if not (out["cpu_box_rel_err"] < F32_REL_TOL
            and out["cpu_score_rel_err"] < F32_REL_TOL):
        raise AssertionError(f"det_flip_golden: card vs CPU: {out}")


def _nus_tree(ctx):
    """nuScenes-format files of synthetic frames (NUS_TREE) and their info
    pkls in a temporary directory, removed at exit; written once."""
    if "nus_infos" not in ctx:
        import atexit
        import shutil
        import tempfile
        from link_tpu_torch.data.nuscenes import write_synthetic_infos
        root = tempfile.mkdtemp(prefix="nus_")
        atexit.register(shutil.rmtree, root, True)
        t0 = time.perf_counter()
        ctx["nus_infos"] = write_synthetic_infos(root, NUS_TREE, NUS_SWEEPS,
                                                 seed=0)
        ctx["nus_root"] = root
        log(f"wrote nuScenes-format files of {NUS_TREE} keyframes, "
            f"{NUS_SWEEPS} sweeps, in {time.perf_counter() - t0:.1f} s")
    return ctx["nus_infos"]


def _det_conv_count(model) -> int:
    """Sparse convs with a kernel map per det forward: each SubM conv, each
    K > 1 down conv, and 4 (3 downs and the extra conv)."""
    from link_tpu_torch.models.scn import SubMConv3d
    from link_tpu_torch.nn.modules import SparseConv3d
    return sum(1 for mod in model.modules()
               if isinstance(mod, SubMConv3d)
               or (isinstance(mod, SparseConv3d)
                   and math.prod(mod.kernel_size) > 1)) + 4


DET_PLANS = 8     # 4 SubM levels (a window join each), 3 downs + the extra
# the double-flip batch: 4 frames' level-0 lattice exceeds the dense aux
# grid's bound (ops/elk.DENSE_AUX_MAX_BYTES), so level 0's ELK block takes
# the sparse aux join, as in det training at batch 2
DET_BATCH4_JOINS = DET_PLANS + 1


def phase_det_tta_main(res, ctx, rounds=3):
    """det_test's double-flip path at full width: CenterPoint-ELKv3 bf16,
    seed-0 weights, each frame's [orig, y-flip, x-flip, xy-flip] as one
    batch of 4 at capacity 4 x 163,840, fused at decode, rotated NMS on the
    card (--device-nms), the kept rows copied to the host; on the val
    frames of write_synthetic_infos that have their 9 sweeps (the first
    keyframe, whose sweeps repeat it, is left out). Launches per frame
    around one pass, ms per frame (best round), the profile (device busy
    ms, idle share, join sites) and peak memory. Then the batch-4 forward
    in float32 against the four batch-1 forwards of the flipped inputs."""
    import torch
    from link_tpu_torch.inference import masked_rows
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    from link_tpu_torch.tools import det_test

    infos = _nus_tree(ctx)
    args = det_test.parse_args(["--info-path", infos["val"],
                                "--root-path", ctx["nus_root"],
                                "--double-flip", "--dtype", "bfloat16",
                                "--device-nms"])
    ds = det_test.make_dataset(args)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(1, len(ds))]
    load_s = (time.perf_counter() - t0) / len(samples)
    run = det_test.DetTest(args, "cuda")
    batches = [run.batch(s) for s in samples]
    n = len(batches)
    caps = run.model.backbone.capacities
    levels = {"val frame": _det_level_rows(samples[0]["coords_zyx"]),
              "hold frame": _det_level_rows(_hold_frame()[0]["coords_zyx"])}
    res["det_level_rows"] = {"capacities_per_frame": [c // 4 for c in caps],
                             **levels}
    log(f"det rows a frame needs at levels 0-3: {levels}, capacities per "
        f"frame {[c // 4 for c in caps]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    masked_rows(run.forward(batches[0]))                      # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outs = [run.forward(b) for b in batches]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    res["det_tta_launches"] = launches

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            masked_rows(run.forward(b))
        times.append((time.perf_counter() - t0) * 1e3 / n)
    kept = []
    for out in outs:
        for boxes, scores, labels, keep in out:
            if boxes.shape[0] != 1 or not torch.isfinite(boxes[keep]).all():
                raise AssertionError("det tta: batch or non-finite boxes "
                                     f"{tuple(boxes.shape)}")
        pb, ps, pl = run.detections(masked_rows(out))
        kept.append(len(ps))
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile(lambda: [masked_rows(run.forward(b)) for b in batches],
                    n, min(times), "frame", ranges=(JOIN_RANGE,))
    convs = _det_conv_count(run.model)
    per_frame = {k: v / n for k, v in launches.items() if v}
    res["det_tta"] = {
        "frames": n, "nnz": [int(b["nnz"]) for b in batches],
        "load_s_per_frame": load_s, "ms_per_frame": times,
        "peak_mem_gb": peak, "kept": kept, "launches_per_frame": per_frame,
        "rotated_nms_launches_per_frame": launches["rotated_nms"] / n}
    res["det_tta_profile"] = prof
    log(f"det tta (double flip, bf16, batch 4 at {run.cap} rows, device "
        f"NMS), {n} frames ({res['det_tta']['nnz']} voxels of the 4 "
        f"flips): ms per frame per round {[round(t, 2) for t in times]}, "
        f"launches per frame {per_frame}, rotated_nms launches per frame "
        f"{launches['rotated_nms'] / n}, peak memory {peak:.2f} GB, kept "
        f"{kept}; frame read and voxelized 4 x in {load_s:.2f} s")
    _check_join_sites(prof, "frame", launches["sorted_join"] / n)
    if (launches["sorted_join"] != n * DET_BATCH4_JOINS
            or launches["window_conv"] + launches["gather_conv"]
            != n * convs
            or launches["rotated_nms"] != n * kernels.ROTATED_NMS_LAUNCHES
            or min(launches[k] for k in ("sorted_join", "window_conv",
                                         "gather_conv")) == 0):
        raise AssertionError(f"det tta launches {launches}: expected "
                             f"{DET_BATCH4_JOINS} joins, {convs} convs and "
                             "one rotated_nms call per frame")
    ctx.update(tta_run=run, tta_batches=batches)
    _tta_hold(res, ctx)


HOLD_PATCH_POINTS = 150000
# the det backbone's strided convs (models/scn.py): kernel, stride, padding
DET_DOWNS = ((3, 2, (1, 1, 1)), (3, 2, (1, 1, 1)), (3, 2, (1, 1, 0)))


def _det_level_rows(coords_zyx, grid=(1440, 1440, 41)) -> list:
    """Rows a frame needs at det levels 0-3: its voxels, then the output
    set of each strided conv (every cell that some input reaches through
    the kernel), on the host. Against DET_CAPACITIES, what a level drops."""
    import itertools
    c = np.asarray(coords_zyx)[:, ::-1].astype(np.int64)
    shape = np.asarray(grid)
    rows = [len(c)]
    for k, st, pad in DET_DOWNS:
        pad = np.asarray(pad)
        out_shape = (shape + 2 * pad - k) // st + 1
        outs = []
        for kk in itertools.product(range(k), repeat=3):
            num = c + pad - np.asarray(kk)
            o = num[(num % st == 0).all(1)] // st
            outs.append(o[((o >= 0) & (o < out_shape)).all(1)])
        c, shape = np.unique(np.concatenate(outs), axis=0), out_shape
        rows.append(len(c))
    return rows


def _hold_frame(seed: int = 0):
    """The 4 flipped voxelizations of a frame whose every level fits det
    capacities: 150,000 points on a 20 m x 20 m ground patch. The
    synthetic frames scatter their voxels, so their levels 1-3 overflow
    (`_det_level_rows`, logged by det_tta_main), and an overflow drops rows
    by batch position: batch 4 and batch 1 would drop different rows."""
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.data.nuscenes import make_double_flip_variants
    rng = np.random.default_rng(seed)
    n = HOLD_PATCH_POINTS
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                    rng.normal(-1.0, 0.03, n), rng.uniform(0, 255, n),
                    np.zeros(n)], 1).astype(np.float32)
    args = ((0.075, 0.075, 0.2), (-54, -54, -5.0, 54, 54, 3.0), 10, 160000)
    voxels, coords_zyx, nppv = dp.points_to_voxel(pts, *args)
    return [{"voxels": voxels, "coords_zyx": coords_zyx,
             "num_points": nppv}] + make_double_flip_variants(pts, *args)


def _tta_hold(res, ctx):
    """The batch-4 forward in float32 (TF32 off) at det_test's double-flip
    capacity against four batch-1 forwards of the same flipped inputs
    (`_hold_frame`) at det_test's capacity, same weights: every head map
    of each group within DET_GOLDEN_REL_TOL."""
    import torch
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.models.voxelnet import VoxelNet
    from link_tpu_torch.tools import det_test
    cap = det_test.CAPACITY
    group = _hold_frame()

    def model(b):
        c = cap * b
        return VoxelNet(batch_size=b, grid_shape=det_test.GRID,
                        capacities=(c, c // 2, c // 4, c // 8),
                        device="cuda",
                        generator=torch.Generator().manual_seed(0)).eval()

    m4, m1 = model(4), model(1)
    m1.load_state_dict(m4.state_dict())
    b4 = dp.collate_det(group, 4 * cap)
    errs = {}
    with torch.inference_mode():
        p4 = m4(*dp.det_inputs(b4, "cuda"))
        for g, single in enumerate(group):
            p1 = m1(*dp.det_inputs(dp.collate_det([single], cap), "cuda"))
            for t, (a, b) in enumerate(zip(p4, p1)):
                for key in a:
                    errs[f"group {g} task {t} {key}"] = rel_err(
                        a[key][g:g + 1], b[key])
    worst = max(errs, key=errs.get)
    res["det_tta_hold"] = {"maps": len(errs), "worst": worst,
                           "worst_rel_err": errs[worst]}
    log(f"det tta hold: batch 4 vs 4 x batch 1 in float32, {len(errs)} "
        f"maps, worst {errs[worst]:.3g} ({worst}; tol {DET_GOLDEN_REL_TOL})")
    if not errs[worst] < DET_GOLDEN_REL_TOL:
        raise AssertionError(f"det tta hold: {worst} rel err {errs[worst]}")
    del m1
    ctx["tta_f32"] = (m4, b4)


def _tta_shapes(res, ctx, kernels, iters=5):
    """Every kernel of the double-flip forward (batch 4 at 655,360 rows)
    at each of its shapes, on the inputs one more forward gives it, in
    bfloat16 (det_tta_main's model) and float32 (the hold's):
    `gather_conv` and `window_conv` against their twins (f32 < 1e-5, bf16
    < 8e-3, bit-equal over two runs), `sorted_join` exactly at each of its
    calls; each timed beside its bound."""
    import torch
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.sparse.coords import CoordTable
    run, batches = ctx.pop("tta_run"), ctx.pop("tta_batches")
    m4, b4 = ctx.pop("tta_f32")
    recs = {}
    with torch.inference_mode():
        with ShapeRecorder() as recs["bfloat16"]:
            run.model(*dp.det_inputs(batches[0], "cuda"))
        with ShapeRecorder() as recs["float32"]:
            m4(*dp.det_inputs(b4, "cuda"))
    torch.cuda.synchronize()
    conv, window, joins = [], [], []
    for dt, rec in recs.items():
        role = f"det batch 4 {dt}"
        for feats, idx, weight in rec.conv.values():
            conv.append(_conv_case(kernels, feats, idx, weight, iters,
                                   role=role))
        for feats, plan, weight in rec.window.values():
            window.append(dict(_window_case(kernels, feats, plan, weight,
                                            iters), role=role))
    # the float32 pass joins the same coordinates: its calls are the same
    for i, (hi, lo, perm, base, offs, mult, mode) in enumerate(
            recs["bfloat16"].joins):
        joins.append(_join_case(kernels, CoordTable(hi, lo, perm), base,
                                offs, mode, iters, mult=mult,
                                role=f"det batch 4 join {i}"))
    del recs, run, m4
    torch.cuda.empty_cache()
    res["tta_conv_cases"] = conv
    res["tta_window_cases"] = window
    res["tta_join_cases"] = joins
    log(f"tta shapes (batch 4): gather_conv at {len(conv)}, window_conv at "
        f"{len(window)} shapes (bf16 and f32), each within its tolerance "
        f"and bit-equal over two runs; sorted_join at {len(joins)} calls, "
        "each equal to its twin; kernel / bound ms: gather_conv "
        f"{sum(c['ms'] for c in conv):.3f} / "
        f"{sum(c['bound_ms'] for c in conv):.3f}, window_conv "
        f"{sum(c['ms'] for c in window):.3f} / "
        f"{sum(c['bound_ms'] for c in window):.3f}, sorted_join "
        f"{sum(c['ms'] for c in joins):.3f} / "
        f"{sum(c['bound_ms'] for c in joins):.3f}")
    if not conv or not window or len(joins) != DET_BATCH4_JOINS:
        raise AssertionError(f"tta shapes: {len(conv)} gather_conv, "
                             f"{len(window)} window_conv shapes, "
                             f"{len(joins)} joins")


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


def _wgrad_f64(feats, g, bwd_idx):
    """The plain twin's sum (`gather_wgrad_plain`) in float64."""
    import torch
    m, co = g.shape
    f = feats.double()
    ext = torch.cat([g.double(), g.new_zeros((1, co), dtype=torch.float64)])
    safe = torch.where(bwd_idx >= 0, bwd_idx,
                       torch.full_like(bwd_idx, m)).long()
    return torch.stack([f.T @ ext[safe[kk]] for kk in range(safe.shape[0])])


def _wgrad_case(kernels, feats, g, bwd_idx, iters, work=None, role=""):
    """gather_wgrad vs its plain twin on one shape: error, two runs
    bit-equal, times, bound (and PR 3's CUDA-core bound beside it). `work`
    is the work list the main path hands the kernel (built here when None).
    The error is held against the twin's sum in float64: a weight gradient
    can cancel a thousandfold (the det stem's), and the float32 twin then
    misses the exact sum by up to 6e-6 of its largest entry, most of the
    1e-5 bound; the error against the float32 twin is kept beside."""
    import torch
    if work is None:
        work = kernels.wgrad_work_list(bwd_idx)
    got = kernels.gather_wgrad(feats, g, bwd_idx, work)
    want = _wgrad_f64(feats, g, bwd_idx)
    twin = kernels.gather_wgrad_plain(feats, g, bwd_idx)
    again = kernels.gather_wgrad(feats, g, bwd_idx, work)
    torch.cuda.synchronize()
    dt = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    err = float((got.double() - want).abs().max() / want.abs().max())
    err_twin = rel_err(got, twin)
    twin_err = float((twin.double() - want).abs().max() / want.abs().max())
    del twin
    n, ci = feats.shape
    m, co = g.shape
    k = bwd_idx.shape[0]
    isz = feats.element_size()
    hits = int((bwd_idx >= 0).sum())
    # the timed call reads feats, g and the work list (an (i, j) pair of
    # int32 per hit and the K + 1 tap offsets; not bwd_idx) once and
    # writes dW once; the products of the hits on the tensor cores (TC_OPS)
    nbytes = (n * ci * isz + m * co * isz + 8 * hits + 4 * (k + 1)
              + k * ci * co * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = 2.0 * hits * ci * co
    t_ops = ops / TC_OPS[dt] * 1e3
    shape = f"N={n} M={m} K={k} Ci={ci} Co={co} {dt}"
    case = {
        "shape": shape, "role": role,
        "rel_err": err, "tol": F32_REL_TOL,
        "rel_err_vs_f32_twin": err_twin, "f32_twin_rel_err": twin_err,
        "max_abs_err": float((got.double() - want).abs().max()),
        "same_twice": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: kernels.gather_wgrad(feats, g, bwd_idx, work),
                      iters, f"gather_wgrad {shape}"),
        "plain_ms": cuda_ms(
            lambda: kernels.gather_wgrad_plain(feats, g, bwd_idx), iters,
            f"gather_wgrad_plain {shape}"),
        "bound_ms": max(t_bytes, t_ops), "bound_bytes_ms": t_bytes,
        "bound_ops_ms": t_ops,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_cuda_core_ms": max(t_bytes, ops / PEAK_OPS["float32"] * 1e3),
        "library_ms": None, "hits": hits,
    }
    log(f"gather_wgrad {shape}{' (' + role + ')' if role else ''}: rel err "
        f"{err:.3g} against the float64 sum (tol {F32_REL_TOL}; against the "
        f"float32 twin {err_twin:.3g}, the twin's own {twin_err:.3g}), same "
        f"twice {case['same_twice']}, "
        f"kernel {case['ms']:.4f} ms, twin {case['plain_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms ({case['bound_by']}; bytes "
        f"{t_bytes:.4f}, operations {t_ops:.4f}), hits {hits} of {k * n}")
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

    # the work list of the level-0 plan's inverse map: built on the card by
    # three small kernels, equal to its plain twin, timed beside it
    bwd0 = plan_bwd_idx(subm)
    work = kernels.wgrad_work_list(bwd0)
    twin = kernels.wgrad_work_list_plain(bwd0)
    torch.cuda.synchronize()
    total = int(twin.tap_off[-1])
    if not (torch.equal(work.tap_off, twin.tap_off)
            and torch.equal(work.hit_i[:total], twin.hit_i[:total])
            and torch.equal(work.hit_j[:total], twin.hit_j[:total])):
        raise AssertionError("wgrad_work_list: differs from its plain twin")
    # bwd_idx read once, the (i, j) pair of each hit and the K + 1 tap
    # offsets written once; a compare and a prefix sum per slot is
    # negligible beside that at the int32 rate
    k0 = bwd0.shape[0]
    t_bytes = (k0 * n * 4 + 8 * total + 4 * (k0 + 1)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * k0 * n / PEAK_OPS["int32"] * 1e3
    res["wgrad_work_list"] = {
        "shape": f"K={k0} N={n} hits={total}",
        "launches_per_build": kernels.WORK_LIST_LAUNCHES,
        "ms": cuda_ms(lambda: kernels.wgrad_work_list(bwd0), iters,
                      "wgrad_work_list"),
        "plain_ms": cuda_ms(lambda: kernels.wgrad_work_list_plain(bwd0),
                            iters, "wgrad_work_list_plain"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"wgrad_work_list K={k0} N={n}: equal to its twin ({total} hits), "
        f"{res['wgrad_work_list']['ms']:.4f} ms on the card in "
        f"{kernels.WORK_LIST_LAUNCHES} launches, twin "
        f"{res['wgrad_work_list']['plain_ms']:.4f} ms, bound "
        f"{res['wgrad_work_list']['bound_ms']:.4f} ms "
        f"({res['wgrad_work_list']['bound_by']})")

    wgrad, function = [], []
    for dtype in (torch.float32, torch.bfloat16):
        # (feats rows, Ci, out rows, Co, forward map, inverse map, role):
        # submanifold 64 -> 64, the stem 4 -> 64, the decoder's first conv
        # after the skip concat 128 -> 64 (two Ci tiles of the weight
        # gradient, Co = 128 in the feature gradient), the K=8 down conv
        # and the transposed conv over its inverse
        for rows, ci, m, co, idx, bwd, role in (
                (n, 64, n, 64, subm.in_idx, bwd0, "train level 0 64->64"),
                (n, 4, n, 64, subm.in_idx, bwd0, "train stem 4->64"),
                (n, 128, n, 64, subm.in_idx, bwd0,
                 "train decoder 128->64"),
                (n, 64, m_down, 64, down.in_idx, plan_bwd_idx(down),
                 "train K=8 down"),
                (m_down, 64, n, 64, down.inv_idx, down.in_idx,
                 "train K=8 transposed")):
            feats = rand((rows, ci), dtype)
            wgrad.append(_wgrad_case(kernels, feats, rand((m, co), dtype),
                                     bwd, iters, role=role))
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
            builds = kernels.wgrad_work_list.builds
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
    res["train_work_list_builds"] = builds
    res["train_losses"] = losses
    res["train_ms_per_step"] = times
    res["train_scans_per_s"] = 2 * len(times) / (sum(times) / 1e3)
    res["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["train_lr"] = [lr(it) for it in range(timed_steps + 1)]
    log(f"train path f32, batch 2, {[int(b['nnz']) for b in batches]} "
        f"voxels: loss per step {[round(v, 4) for v in losses]}; ms per step "
        f"{[round(v, 1) for v in times]}; {res['train_scans_per_s']:.3f} "
        f"training scans/s; launches in one step {launches} (expected "
        f"{want}), and {builds} weight-gradient work lists built "
        f"({builds * kernels.WORK_LIST_LAUNCHES} launches); peak memory "
        f"{res['train_peak_mem_gb']:.2f} GB")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"train launch counts {launches} differ from "
                             f"the expected {want}")
    # one list per inverse map a weight gradient reads: at most two for
    # each of the 9 plans (its own map and, for a down conv, the transposed
    # conv's)
    if not 0 < builds <= 2 * 9:
        raise AssertionError(f"{builds} work lists built in one step")
    if no_grad or still:
        raise AssertionError(f"parameters without a gradient: {no_grad}; "
                             f"BatchNorms whose running mean stayed 0: "
                             f"{still}")
    ctx.update(train_step=step, train_next=timed_steps + 1)


def phase_train_profile(res, ctx):
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    from link_tpu_torch.train.trainer import RANGES
    step, it = ctx["train_step"], ctx["train_next"]
    prof = _profile(lambda: step(it), 1, min(res["train_ms_per_step"]),
                    "step", ranges=RANGES + (JOIN_RANGE,))
    res["train_profile"] = prof
    _check_join_sites(prof, "step", res["train_launches"]["sorted_join"])
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
# the other seg families' training, on SemanticKITTI-format files

# scans written in the dataset's layout: train (00), val (08), test (11)
KITTI_TREE = {"00": 8, "08": 2, "11": 2}
KITTI_RAW_POINTS = 120000
FAMILY_TRAIN_BATCHES = 4
# the tests' tiny size (tests/torch_train_family.py)
TINY_CAPS = (384, 192, 96, 48, 24)
TINY_CR = 0.125
SEG_FILES_LOG = os.path.join(HERE, "chiprun_out", "seg_files.log")
TTA1_MISMATCH = 1e-4   # share of points where --tta 1 may differ from the
#                        plain forward: argmax of the softmax, not of the
#                        logits, so two logits within float rounding tie


def _kitti_tree(ctx) -> str:
    """A SemanticKITTI tree of synthetic scans (KITTI_TREE) in a temporary
    directory, removed at exit; written once."""
    if "kitti_root" not in ctx:
        import atexit
        import shutil
        import tempfile
        from link_tpu_torch.data.semantic_kitti import write_synthetic_tree
        root = tempfile.mkdtemp(prefix="kitti_")
        atexit.register(shutil.rmtree, root, True)
        t0 = time.perf_counter()
        write_synthetic_tree(root, KITTI_TREE, KITTI_RAW_POINTS, seed=0)
        log(f"SemanticKITTI tree {KITTI_TREE} of {KITTI_RAW_POINTS}-point "
            f"scans written in {time.perf_counter() - t0:.1f} s")
        ctx["kitti_root"] = root
    return ctx["kitti_root"]


def phase_seg_families_train(res, ctx, timed_steps=6):
    """Each of ELKEncoder, MinkUNet and SPVCNN trained by its config's
    recipe (cr 1.0, the config's capacities x batch 2, float32, SGD under
    cosine_warmup, SPVCNN's seeded dropout) on batches read back through
    `SemanticKITTI` from a tree written in the dataset's layout: 1 warm and
    `timed_steps` timed steps (ms per step, launches of each kernel in one
    step against the expected counts, peak memory), then one step
    profiled (device busy ms, idle share, the join-site check)."""
    import torch
    from link_tpu_torch.data.collate import collate_scans
    from link_tpu_torch.data.semantic_kitti import SemanticKITTI
    from link_tpu_torch.models import builder
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
    from link_tpu_torch.nn.modules import SparseConv3d
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse.coords import JOIN_INPUT_RANGE, JOIN_RANGE
    from link_tpu_torch.train import trainer as T
    from link_tpu_torch.utils.config import load_config

    root = _kitti_tree(ctx)
    cfgs = {name: load_config(_family_config(name)) for name in FAMILIES}
    cfg0 = cfgs[FAMILIES[0]]
    for name, cfg in cfgs.items():
        if (cfg.batch_size != 2 or cfg.dataset.voxel_size != 0.05
                or tuple(cfg.model.capacities) != DEFAULT_CAPACITIES):
            raise AssertionError(f"{name}: the config's recipe changed")
    caps = tuple(cfg0.batch_size * c for c in cfg0.model.capacities)
    ds = SemanticKITTI(root, "train", cfg0.dataset.voxel_size,
                       cfg0.dataset.num_points)
    t0 = time.perf_counter()
    batches = [collate_scans(
        [ds.__getitem__(2 * s + k, np.random.default_rng(300 + s))
         for k in range(2)], caps[0], ignore_label=cfg0.data.ignore_label)
        for s in range(FAMILY_TRAIN_BATCHES)]
    log(f"{len(batches)} batches of 2 scans read back through SemanticKITTI "
        f"in {time.perf_counter() - t0:.1f} s: "
        f"{[int(b['nnz']) for b in batches]} voxels")
    res["family_train"], ctx["family_train"] = {}, {}
    for name in FAMILIES:
        cfg = cfgs[name]
        model = builder.make_model(cfg, capacities=caps, dtype="float32",
                                   device="cuda",
                                   generator=torch.Generator().manual_seed(0))
        lr = builder.make_lr_schedule(cfg)
        opt = builder.make_optimizer(cfg, model.parameters(), lr(0))

        def step(it, model=model, opt=opt, lr=lr,
                 ignore=cfg.criterion.ignore_index):
            return T.seg_train_step(model, opt, batches[it % len(batches)],
                                    ignore_label=ignore, lr=lr(it))

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(0)["loss"])]                      # warm-up
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
                launches = {fn.__name__: fn.launches
                            for fn in kernels.KERNELS}
                builds = kernels.wgrad_work_list.builds
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        convs = sum(1 for mod in model.modules()
                    if isinstance(mod, SparseConv3d)
                    and math.prod(mod.kernel_size) > 1)
        aux = (_elk_aux_paths(model, None) if name == "linkencoder"
               else None)
        joins = FAMILY_PLANS + (
            aux.count("sparse") + 4 if name == "linkencoder"
            else SPVCNN_POINT_JOINS if name == "spvcnn" else 0)
        # as train_main: the stem's first conv needs no feature gradient
        want = {"gather_conv": 2 * convs - 1, "gather_wgrad": convs,
                "sorted_join": joins}
        prof = _profile(lambda: step(timed_steps + 1), 1, min(times), "step",
                        ranges=T.RANGES + (JOIN_RANGE, JOIN_INPUT_RANGE))
        _check_join_sites(prof, "step", joins)
        fam = {"ms_per_step": times, "losses": losses,
               "launches_per_step": launches, "expected": want,
               "work_list_builds": builds, "profile": prof,
               "peak_mem_gb": peak / 2**30,
               "resident_before_gb": resident / 2**30,
               "voxels": [int(b["nnz"]) for b in batches],
               "params": sum(p.numel() for p in model.parameters()),
               "gather_conv_ms_per_step": _kernel_ms(
                   prof, ("gather_conv", "w_frag"), "step"),
               "gather_wgrad_ms_per_step": _kernel_ms(
                   prof, ("gather_wgrad", "wgrad_reduce", "list_count",
                          "list_scan", "list_write"), "step")}
        res["family_train"][name] = fam
        res[f"family_train_launches_{name}"] = launches
        log(f"{name} training f32, batch 2, cr1.0 (config recipe): loss per "
            f"step {[round(v, 4) for v in losses]}; ms per step "
            f"{[round(v, 1) for v in times]} (median "
            f"{float(np.median(times)):.1f}); device busy "
            f"{prof['device_busy_ms_per_step'] or float('nan'):.2f} ms, "
            f"idle share {prof['idle_share'] or float('nan'):.3f}; "
            f"{prof['launches_per_step']:.0f} launches per step; kernel "
            f"launches {launches} (expected {want}), {builds} work lists "
            f"built; gather_conv {fam['gather_conv_ms_per_step']:.2f} ms, "
            f"gather_wgrad {fam['gather_wgrad_ms_per_step']:.2f} ms per "
            f"step; peak memory {fam['peak_mem_gb']:.2f} GB "
            f"({fam['resident_before_gb']:.2f} GB resident before)")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite training loss {losses}")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: launch counts {launches} differ "
                                 f"from the expected {want}")
        if not 0 < builds <= 2 * FAMILY_PLANS:
            raise AssertionError(f"{name}: {builds} work lists in one step")
        no_grad = [k for k, p in model.named_parameters()
                   if p.grad is None or not bool((p.grad != 0).any())]
        if no_grad:
            raise AssertionError(f"{name}: parameters without a gradient: "
                                 f"{no_grad}")
        ctx["family_train"][name] = step
    ctx["family_train_next"] = timed_steps + 2


def _tiny_family_model(name, device):
    """The family at the tests' tiny size (cr 0.125, TINY_CAPS), seed 0;
    the encoder at its config's r=3, s=7, groups 2, cos; SPVCNN without
    dropout (the card's and the CPU's generators draw other masks)."""
    import torch
    from link_tpu_torch.models.linkencoder import ELKEncoder
    from link_tpu_torch.models.minkunet import MinkUNet
    from link_tpu_torch.models.spvcnn import SPVCNN
    kw = dict(cr=TINY_CR, capacities=TINY_CAPS, device=device,
              generator=torch.Generator().manual_seed(0))
    if name == "linkencoder":
        return ELKEncoder(20, r=3, s=7, groups=2, baseop="cos", **kw)
    if name == "minkunet":
        return MinkUNet(20, **kw)
    return SPVCNN(20, dropout_rate=0.0, **kw)


def phase_seg_families_train_grad(res, ctx):
    """One training step of each family at the tests' tiny size (two
    synthetic scans of seed 11, 0.4 m voxels) on the card against the same
    step on the CPU: the loss, and every gradient within 1e-4 of the
    largest gradient, the CPU's ReLUs given the card's side below
    DET_TRAIN_FLIP of their call's largest |x|, as det_train_grad."""
    import torch
    from link_tpu_torch.data.collate import collate_scans
    from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
    from link_tpu_torch.train import trainer as T

    ds = SyntheticSemanticKITTI(length=2, num_points=(TINY_CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=11)
    batch = collate_scans([ds[0], ds[1]], TINY_CAPS[0])
    res["family_train_grad"] = {}
    for name in FAMILIES:
        out, masks, flips = {}, None, []
        for run, device, force in (("cuda", "cuda", False),
                                   ("cpu", "cpu", True),
                                   ("cpu unforced", "cpu", False)):
            model = _tiny_family_model(name, device)
            opt = T.make_sgd(model.parameters(), 0.05)
            with ReluMasks(force=masks if force else None) as relus:
                m = T.seg_train_step(model, opt, batch)
            if run == "cuda":
                masks = [mk.cpu() for mk in relus.masks]
            elif force:
                flips = relus.flips
            out[run] = (float(m["loss"]),
                        {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()
                         if p.grad is not None})
        (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
        top, errs, leaf_errs = _grad_errs(grads_c, grads_g)
        _, free_errs, _ = _grad_errs(out["cpu unforced"][1], grads_g)
        worst = max(errs, key=errs.get)
        leaf_worst = max(leaf_errs, key=leaf_errs.get)
        free_worst = max(free_errs, key=free_errs.get)
        res["family_train_grad"][name] = {
            "loss_cpu": loss_c, "loss_cuda": loss_g, "worst": worst,
            "worst_rel_err": errs[worst], "leaf_worst": leaf_worst,
            "leaf_worst_rel_err": leaf_errs[leaf_worst],
            "leaves": len(errs), "largest_gradient": top,
            "relu_calls": len(masks), "relu_flips": flips,
            "unforced_worst_rel_err": free_errs[free_worst]}
        log(f"{name} train_grad (tiny, card vs CPU): loss cpu {loss_c:.6f} "
            f"card {loss_g:.6f}; {len(errs)} gradients, worst "
            f"{errs[worst]:.3g} of the largest {top:.4g} ({worst}; tol "
            f"{TRAIN_GRAD_REL_TOL}); against its own leaf's largest "
            f"{leaf_errs[leaf_worst]:.3g} ({leaf_worst}); ReLU flips "
            f"{flips} of {len(masks)} calls; the CPU on its own sides: "
            f"{free_errs[free_worst]:.3g} (not gated)")
        if (sorted(grads_c) != sorted(grads_g)
                or abs(loss_c - loss_g) > 1e-4 * abs(loss_c)
                or not errs[worst] < TRAIN_GRAD_REL_TOL
                or any(share >= DET_TRAIN_FLIP for _, _, share in flips)):
            raise AssertionError(f"{name} train_grad: loss {loss_c} vs "
                                 f"{loss_g}, worst gradient {worst} rel err "
                                 f"{errs[worst]}, ReLU flips {flips}")


def phase_seg_files(res, ctx):
    """The seg tools on the written SemanticKITTI tree, on the card, with
    MinkUNet's config recipe: `seg_train` without --synthetic for 2 epochs,
    the second resumed (`--stop-after-epoch 1`, then `--resume auto`);
    `seg_evaluate` on its checkpoint: `--tta 1` predicts what the plain
    forward does (but for softmax ties, TTA1_MISMATCH), `--tta 4` gives
    finite votes, `--split test --save-labels` writes one `.label` of a
    uint32 per point for each test scan; then `train_supervisor` on a child
    that exits 17 after checkpointing epoch 1 and completes on its
    relaunch. The tools' own output goes to chiprun_out/seg_files.log."""
    import contextlib
    import json as _json
    import shutil
    import tempfile
    from link_tpu_torch.data.semantic_kitti import SemanticKITTI
    from link_tpu_torch.tools import seg_evaluate, seg_train

    root = _kitti_tree(ctx)
    config = _family_config("minkunet")
    data = [f"dataset.root={root}"]
    work = tempfile.mkdtemp(prefix="seg_files_")
    out = {}
    try:
        run_dir = os.path.join(work, "run")
        os.makedirs(os.path.dirname(SEG_FILES_LOG), exist_ok=True)
        with open(SEG_FILES_LOG, "w") as logf, \
                contextlib.redirect_stdout(logf):
            t0 = time.perf_counter()
            seg_train.main([config, "--run-dir", run_dir, "--epochs", "2",
                            "--stop-after-epoch", "1", *data])
            seg_train.main([config, "--run-dir", run_dir, "--epochs", "2",
                            "--resume", "auto", *data])
            out["train_s"] = time.perf_counter() - t0
            ckpt = os.path.join(run_dir, "latest.pt")

            def evaluate(name, *args):
                return seg_evaluate.evaluate(seg_evaluate.parse_args(
                    [config, ckpt, "--save-labels", os.path.join(work, name),
                     *args, *data]))

            t0 = time.perf_counter()
            runs = {"plain": evaluate("plain"),
                    "tta1": evaluate("tta1", "--tta", "1"),
                    "tta4": evaluate("tta4", "--tta", "4"),
                    "test": evaluate("test", "--split", "test")}
            out["evaluate_s"] = time.perf_counter() - t0
        text = open(SEG_FILES_LOG).read()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            epochs = {r["epoch"]: r for r in map(_json.loads, f)
                      if "epoch" in r}
        out["epochs"] = epochs
        if sorted(epochs) != [1, 2] or "resumed" not in text or not all(
                np.isfinite(r["loss/train"]) for r in epochs.values()):
            raise AssertionError(f"seg_files: seg_train epochs {epochs}")
        for name, r in runs.items():
            out[name] = {k: r[k] for k in ("miou", "ms_per_scan", "scans",
                                           "overflow_scans", "votes_finite",
                                           "label_files")}
        mismatch, points = 0, 0
        for a, b in zip(runs["plain"]["label_files"],
                        runs["tta1"]["label_files"]):
            pa, pb = np.fromfile(a, np.uint32), np.fromfile(b, np.uint32)
            if pa.shape != pb.shape:
                raise AssertionError(f"seg_files: {a} and {b} differ in size")
            mismatch += int((pa != pb).sum())
            points += len(pa)
        out["tta1_mismatch"] = [mismatch, points]
        test_ds = SemanticKITTI(root, "test")
        sizes = []
        for path, label in zip(test_ds.files, runs["test"]["label_files"]):
            n_points = os.path.getsize(path) // 16
            sizes.append((n_points, os.path.getsize(label) // 4))
        out["test_label_points"] = sizes
        log(f"seg_files: seg_train on the tree, epochs "
            f"{[(e, round(r['loss/train'], 4)) for e, r in epochs.items()]} "
            f"(epoch 2 resumed) in {out['train_s']:.1f} s; seg_evaluate val "
            f"mIoU plain {runs['plain']['miou']:.4f}, --tta 1 "
            f"{runs['tta1']['miou']:.4f} ({mismatch} of {points} points "
            f"differ), --tta 4 {runs['tta4']['miou']:.4f} (votes finite "
            f"{runs['tta4']['votes_finite']}); --split test wrote "
            f"{len(runs['test']['label_files'])} label files, (points, "
            f"labels) {sizes}; ms per scan plain "
            f"{[round(v, 1) for v in runs['plain']['ms_per_scan']]}, --tta 4 "
            f"{[round(v, 1) for v in runs['tta4']['ms_per_scan']]}")
        if (mismatch > TTA1_MISMATCH * points or not points
                or runs["tta4"]["votes_finite"] is not True
                or runs["test"]["miou"] is not None
                or len(sizes) != KITTI_TREE["11"]
                or any(p != n or p == 0 for p, n in sizes)):
            raise AssertionError(f"seg_files: {out}")
        out["supervisor"] = _supervised_run(config, root, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seg_files"] = out


def _supervised_run(config, root, work):
    """`python3 -m link_tpu_torch.tools.train_supervisor` over a child that
    trains 1 epoch of `config` on the tree, exits 17 after checkpointing
    it, and on its relaunch (given `--resume auto`) finishes epoch 2."""
    import json as _json
    run_dir = os.path.join(work, "supervised")
    flag = os.path.join(work, "crashed_once")
    wrapper = os.path.join(work, "flaky_train.py")
    with open(wrapper, "w") as f:
        f.write(f"""import os, subprocess, sys
first = not os.path.exists({flag!r})
cmd = [sys.executable, "-m", "link_tpu_torch.tools.seg_train", {config!r},
       "--epochs", "2", "dataset.root={root}"] + (
           ["--stop-after-epoch", "1"] if first else []) + sys.argv[1:]
code = subprocess.call(cmd)
if first:
    open({flag!r}, "w").close()
    sys.exit(17)
sys.exit(code)
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = HERE
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "link_tpu_torch.tools.train_supervisor",
         "--max-restarts", "2", "--backoff", "0.01", "--", sys.executable,
         wrapper, "--run-dir", run_dir], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    with open(SEG_FILES_LOG, "a") as f:
        f.write(run.stdout + run.stderr)
    epochs = []
    if os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            epochs = [r["epoch"] for r in map(_json.loads, f) if "epoch" in r]
    out = {"rc": run.returncode, "epochs": epochs, "s": seconds,
           "restarted": "child exited 17" in run.stdout}
    log(f"train_supervisor: rc {run.returncode}, child exited 17 and was "
        f"relaunched {out['restarted']}, epochs logged {epochs}, "
        f"{seconds:.1f} s")
    if (run.returncode != 0 or not out["restarted"] or epochs != [1, 2]
            or "finished ok after 1 restart(s)" not in run.stdout):
        raise AssertionError(f"train_supervisor: {out}; "
                             f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    return out


# --------------------------------------------------------------------------
# detection training


DET_TRAIN_CAPS = (327680, 163840, 81920, 40960)   # det_train's default recipe
DET_TRAIN_TINY_CAPS = (8192, 4096, 2048, 1024)    # tests/test_det_train_step.py
DET_TRAIN_GOLDEN = os.path.join(HERE, "tests", "goldens", "det_train_ab.npz")
DET_TRAIN_ZERO_LEAF = 1e-7   # a leaf whose largest gradient is below this
#                              share of the largest of all holds float noise
#                              (the biases of convs that feed a BatchNorm)
#                              and is held against the largest instead
DET_TRAIN_FLIP = 1e-4       # a ReLU input on other sides on the card and
#                             the CPU: at most this share of its call's
#                             largest |x| (the forward agrees to ~1e-6)
DET_TRAIN_CLI_TIMEOUT = 300


def _det_train_batches(n_batches: int):
    """`n_batches` collated batches of two synthetic train-mode nuScenes
    frames each (targets included) at det_train's default capacity,
    327,680 rows."""
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.data.nuscenes import SyntheticNuScenes
    ds = SyntheticNuScenes(length=2 * n_batches, mode="train",
                           max_voxels=DET_TRAIN_CAPS[0] // 2)
    return [dp.collate_det([ds[2 * i], ds[2 * i + 1]], DET_TRAIN_CAPS[0])
            for i in range(n_batches)]


def _window_backward_case(kernels, WindowConv, GatherConv, plan, ci, co,
                          iters, role):
    """`WindowConv`'s backward on one window plan: the feature gradient
    (`window_conv` over the plan's windows with W[mirror]^T) and the weight
    gradient (`gather_wgrad` over the mirrored map), each against its
    twin, f32 < 1e-5 and bit-equal over two runs, with times and bounds;
    the whole backward through autograd against autograd through the
    plain conv; and the two kernels' time beside `GatherConv`'s backward
    on the same plan (`gather_conv` over the inverse map + the same
    `gather_wgrad`), by graph replay."""
    import torch
    from link_tpu_torch.sparse.conv import (_mirror_index, plan_bwd_idx,
                                            plan_wgrad_work)
    dev = plan.slot.device
    m = plan.slot.shape[1]
    gen = torch.Generator(device=dev).manual_seed(ci)
    feats = torch.randn((m, ci), generator=gen, device=dev)
    w = torch.randn((27, ci, co), generator=gen, device=dev) * (27 * ci) ** -.5
    cot = torch.randn((m, co), generator=gen, device=dev)
    w_bwd = w[_mirror_index(plan.mirror, dev)].transpose(1, 2).contiguous()
    d_feats = _window_case(kernels, cot, plan, w_bwd, iters)
    bwd = plan_bwd_idx(plan)
    work = plan_wgrad_work(plan)
    d_w = _wgrad_case(kernels, feats, cot, bwd, iters, work,
                      role=f"{role} d_W")
    grads = []
    for fn in (lambda f, k: WindowConv.apply(f, k, plan),
               lambda f, k: kernels.window_conv_plain(
                   f, plan.base_pos, plan.slot, plan.groups, k)):
        f = feats.clone().requires_grad_()
        k = w.clone().requires_grad_()
        fn(f, k).backward(cot)
        grads.append((f.grad, k.grad))
    torch.cuda.synchronize()
    errs = {"d_feats": rel_err(grads[0][0], grads[1][0]),
            "d_weight": rel_err(grads[0][1], grads[1][1])}
    w_t = w.transpose(1, 2).contiguous()
    window_ms = cuda_ms(lambda: (
        kernels.window_conv(cot, plan.base_pos, plan.slot, plan.groups,
                            w_bwd),
        kernels.gather_wgrad(feats, cot, bwd, work)), iters,
        f"WindowConv backward {role}")
    gather_ms = cuda_ms(lambda: (
        kernels.gather_conv(cot, bwd, w_t),
        kernels.gather_wgrad(feats, cot, bwd, work)), iters,
        f"GatherConv backward {role}")
    gather_dfeats_ms = cuda_ms(lambda: kernels.gather_conv(cot, bwd, w_t),
                               iters, f"gather_conv d_feats {role}")
    log(f"WindowConv backward {role} ({ci}->{co}): autograd vs the plain "
        f"conv's d_feats {errs['d_feats']:.3g}, d_W {errs['d_weight']:.3g} "
        f"(tol {F32_REL_TOL}); backward {window_ms:.4f} ms (d_feats "
        f"{d_feats['ms']:.4f} + d_W {d_w['ms']:.4f}), GatherConv's "
        f"{gather_ms:.4f} ms (d_feats {gather_dfeats_ms:.4f})")
    if not max(errs.values()) < F32_REL_TOL:
        raise AssertionError(f"WindowConv backward {role}: {errs}")
    return {"role": role, "ci": ci, "co": co, "d_feats": d_feats,
            "d_weight": d_w, "autograd_rel_err": errs,
            "window_backward_ms": window_ms,
            "gather_backward_ms": gather_ms,
            "gather_d_feats_ms": gather_dfeats_ms}


def phase_det_train_kernels(res, ctx, iters=20):
    """`window_conv` and `WindowConv`'s backward at the det step's own
    level-0 plan: two synthetic train-mode frames collated at det_train's
    default capacity (327,680 rows). The forward at 5 -> 16 (the stem) and
    16 -> 16, the feature gradient at 16 -> 16 with W[mirror]^T, and the
    weight gradients 16 -> 16 and 5 -> 16 (the stem's whole backward: the
    voxel means need no gradient). Then level 1 (32 channels), which the
    float32 step sends to the gather form (a 32-channel float32 window
    exceeds one 256 B chunk) and bfloat16 serving takes in the window form:
    off the det step's path, compared and timed all the same."""
    import torch
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse import coords as C
    from link_tpu_torch.sparse.conv import (GatherConv, WindowConv,
                                            add_window_form, build_conv_plan,
                                            plan_bwd_idx, plan_wgrad_work,
                                            window_chunk)
    from link_tpu_torch.sparse.spconv_engine import (spconv_downsample,
                                                     spconv_out_shape)

    dev = torch.device("cuda")
    batch = _det_train_batches(1)[0]
    coords = torch.from_numpy(batch["coords"]).to(dev)
    nnz = torch.tensor(int(batch["nnz"]), dtype=torch.int32, device=dev)
    offs = C.kernel_offsets_np(3)
    plans = {}
    c, n, cap = coords, nnz, DET_TRAIN_CAPS[0]
    for lvl in (0, 1):
        if lvl:
            shape = spconv_out_shape((1440, 1440, 41), (3, 3, 3), (2, 2, 2),
                                     (1, 1, 1))
            c, n = spconv_downsample(coords, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                     shape, DET_TRAIN_CAPS[1])
            cap = DET_TRAIN_CAPS[1]
        table = C.build_table(c, assume_sorted=True)
        plans[lvl] = add_window_form(build_conv_plan(
            c, c, n, offs, cap, in_sorted=True, table=table), table, offs, 1)
        log(f"det train level {lvl}: {int(n)} voxels of 2 frames in {cap} "
            f"rows, windows of {plans[lvl].window} rows")
    if window_chunk(plans[1].window, 32, 4) >= plans[1].window:
        raise AssertionError("det level 1 would take the window form in "
                             "float32: the level-1 case is then on the path")
    gen = torch.Generator(device=dev).manual_seed(3)
    m = plans[0].slot.shape[1]
    forward = [_window_case(
        kernels, torch.randn((m, ci), generator=gen, device=dev), plans[0],
        torch.randn((27, ci, 16), generator=gen, device=dev)
        * (27 * ci) ** -.5, iters) for ci in (5, 16)]
    cases = [_window_backward_case(kernels, WindowConv, GatherConv, plans[0],
                                   16, 16, iters, "det train level 0"),
             _window_backward_case(kernels, WindowConv, GatherConv, plans[1],
                                   32, 32, iters,
                                   "det train level 1 (off the f32 path)")]
    stem = _wgrad_case(kernels, torch.randn((m, 5), generator=gen,
                                            device=dev),
                       torch.randn((m, 16), generator=gen, device=dev),
                       plan_bwd_idx(plans[0]), iters,
                       plan_wgrad_work(plans[0]), role="det train stem d_W")
    res["det_train_window_forward"] = forward
    res["det_train_window_backward"] = cases
    res["det_train_stem_wgrad"] = stem


def _det_tiny_batch():
    """tests/test_det_train_step.py's two tiny frames with their targets,
    collated at capacity 8,192."""
    from link_tpu_torch.data import det_pipeline as dp
    rng = np.random.default_rng(70)
    pr, vs = (-12, -12, -2, 12, 12, 2), (0.5, 0.5, 0.1)
    samples = []
    for i in range(2):
        pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
        v, c, n = dp.points_to_voxel(pts, vs, pr, max_points=5,
                                     max_voxels=4000)
        boxes = np.array([[0.0, 2.0 * i, 0.0, 2.0, 4.0, 1.5, 0, 0, 0.1]],
                         np.float32)
        t = dp.assign_label(boxes, np.array([1]), pc_range=pr, voxel_size=vs,
                            out_size_factor=8, max_objs=10)
        samples.append({"voxels": v, "coords_zyx": c, "num_points": n,
                        "targets": t})
    return dp.collate_det(samples, DET_TRAIN_TINY_CAPS[0], max_points=5)


class ReluMasks:
    """Records, in order, which inputs of every ReLU of a training forward
    (`torch.relu`, `F.relu`, on inputs that need a gradient) are positive;
    given the masks of an earlier run (`force`), applies them to the
    elements whose |x| lies below DET_TRAIN_FLIP of the call's largest
    |x| (each other element takes its own side), and records the flips:
    elements whose own side differs from the given mask, with their |x| as
    a share of the call's largest |x|."""

    def __init__(self, force=None):
        self.masks, self.force, self.flips = [], force, []

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self._real = (torch.relu, F.relu)
        real_relu = self._real[0]

        def relu(x, *a, **kw):
            import torch
            if not (torch.is_grad_enabled() and x.requires_grad):
                return real_relu(x)
            pos = x.detach() > 0
            if self.force is None:
                self.masks.append(pos)
                return real_relu(x)
            given = self.force[len(self.masks)].to(x.device)
            ax = x.detach().abs()
            mask = torch.where(ax < DET_TRAIN_FLIP * ax.max(), given, pos)
            self.masks.append(mask)
            flip = pos != given
            if bool(flip.any()):
                self.flips.append((len(self.masks) - 1, int(flip.sum()),
                                   float(ax[flip].max() / ax.max())))
            return torch.where(mask, x, torch.zeros_like(x))

        torch.relu = relu
        F.relu = lambda x, inplace=False: relu(x)
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F
        torch.relu, F.relu = self._real
        return False


def _grad_errs(grads_c, grads_g):
    """Each leaf's largest difference against the largest gradient of all,
    and against its own leaf's largest (a leaf whose gradient is 0 up to
    noise, below DET_TRAIN_ZERO_LEAF of the largest, against the largest):
    (largest gradient, errors, leaf errors)."""
    top = max(float(g.abs().max()) for g in grads_c.values())
    errs, leaf_errs = {}, {}
    for k, g in grads_c.items():
        diff = float((grads_g[k] - g).abs().max())
        scale = float(g.abs().max())
        scale = scale if scale >= DET_TRAIN_ZERO_LEAF * top else top
        errs[k] = diff / top
        leaf_errs[k] = diff / max(scale, 1e-30)
    return top, errs, leaf_errs


def phase_det_train_grad(res, ctx):
    """One det step of the tiny VoxelNet (seed 0) on the card against the
    same step on the CPU (plain twins): the loss, and every gradient
    within 1e-4 of the largest gradient of all. A ReLU input at float
    noise can take either side on the two devices (and between two runs
    on the card, whose `index_add_` adds in no fixed order), and one such
    element moves every gradient upstream by a whole term; so the CPU step
    takes the card's side for each ReLU input whose |x| lies below
    DET_TRAIN_FLIP of its call's largest, and decides every other input
    itself; a flip (a side that differs from the card's) must lie below
    that share. The same CPU step without the card's sides is compared
    too, and its reading recorded beside, not gated. Each leaf's error
    against its own largest magnitude is printed beside."""
    import torch
    from link_tpu_torch.models.voxelnet import VoxelNet
    from link_tpu_torch.train import det_trainer as DT
    from link_tpu_torch.train import schedules

    batch = _det_tiny_batch()
    out = {}
    masks = None
    for run, device, force in (("cuda", "cuda", False), ("cpu", "cpu", True),
                               ("cpu unforced", "cpu", False)):
        model = VoxelNet(batch_size=2, grid_shape=(48, 48, 40),
                         capacities=DET_TRAIN_TINY_CAPS, device=device,
                         generator=torch.Generator().manual_seed(0))
        opt = DT.make_one_cycle_adam(model, *schedules.one_cycle(1e-3, 100))
        with ReluMasks(force=masks if force else None) as relus:
            m = DT.det_train_step(model, opt, batch)
        if run == "cuda":
            masks = [mk.cpu() for mk in relus.masks]
        elif force:
            flips = relus.flips
        out[run] = (float(m["loss"]),
                    {k: p.grad.detach().cpu()
                     for k, p in model.named_parameters()
                     if p.grad is not None})
    (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
    top, errs, leaf_errs = _grad_errs(grads_c, grads_g)
    _, free_errs, _ = _grad_errs(out["cpu unforced"][1], grads_g)
    worst = max(errs, key=errs.get)
    leaf_worst = max(leaf_errs, key=leaf_errs.get)
    free_worst = max(free_errs, key=free_errs.get)
    res["det_train_grad"] = {"loss_cpu": loss_c, "loss_cuda": loss_g,
                             "worst": worst, "worst_rel_err": errs[worst],
                             "leaf_worst": leaf_worst,
                             "leaf_worst_rel_err": leaf_errs[leaf_worst],
                             "leaves": len(errs), "largest_gradient": top,
                             "relu_calls": len(masks), "relu_flips": flips,
                             "unforced_worst": free_worst,
                             "unforced_worst_rel_err": free_errs[free_worst]}
    log(f"det_train_grad: loss cpu {loss_c:.6f} card {loss_g:.6f}; "
        f"{len(errs)} gradients, worst {errs[worst]:.3g} of the largest "
        f"gradient {top:.4g} ({worst}; tol {TRAIN_GRAD_REL_TOL}); against "
        f"its own leaf's largest {leaf_errs[leaf_worst]:.3g} "
        f"({leaf_worst}); ReLU inputs on other sides than the card's, "
        f"(call, elements, |x| of the call's largest): {flips} of "
        f"{len(masks)} calls (tol {DET_TRAIN_FLIP}); the CPU step on its "
        f"own sides: worst {free_errs[free_worst]:.3g} ({free_worst}; not "
        "gated)")
    if (sorted(grads_c) != sorted(grads_g)
            or abs(loss_c - loss_g) > 1e-4 * abs(loss_c)
            or not errs[worst] < TRAIN_GRAD_REL_TOL
            or any(share >= DET_TRAIN_FLIP for _, _, share in flips)):
        raise AssertionError(f"det_train_grad: loss {loss_c} vs {loss_g}, "
                             f"worst gradient {worst} rel err {errs[worst]}, "
                             f"ReLU flips {flips}")


def phase_det_train_golden(res, ctx):
    """tests/goldens/det_train_ab.npz's 40 steps of the reference dense det
    composite (RPN + CenterHead, two tasks) replayed on the card in float64
    through the port's modules, `center_head_loss` and `OneCycleAdam` fed
    the recorded lr and momentum, against the reference's loss curve at
    the bounds of tests/test_det_convergence_ab.py."""
    import torch
    from link_tpu_torch.data.det_pipeline import TARGET_KEYS
    from link_tpu_torch.models.center_head import CenterHead, center_head_loss
    from link_tpu_torch.models.rpn import RPN
    from link_tpu_torch.train.det_trainer import OneCycleAdam

    g = np.load(DET_TRAIN_GOLDEN)
    tasks = (("car",), ("truck", "bus"))
    steps, n_frames = int(g["steps"]), int(g["n_frames"])
    ref, lrs, moms = (np.asarray(g[k]) for k in ("losses", "lrs", "moms"))
    dev = torch.device("cuda")
    neck = RPN(layer_nums=(2, 2), ds_layer_strides=(1, 2),
               ds_num_filters=(32, 64), us_layer_strides=(1, 2),
               us_num_filters=(32, 32), num_input_features=32,
               dtype="float64", device=dev).double()
    head = CenterHead(in_channels=64, tasks=tasks, share_conv_channel=32,
                      dtype="float64", device=dev).double()
    sd = {k[3:].replace("__", "."): torch.from_numpy(np.array(g[k]))
          for k in g.files if k.startswith("sd_")}
    for prefix, mod in (("neck.", neck), ("bbox_head.", head)):
        mod.load_state_dict({k[len(prefix):]: v.double()
                             if v.is_floating_point() else v
                             for k, v in sd.items() if k.startswith(prefix)},
                            strict=True)
    frames = []
    for i in range(n_frames):
        ex = {"bev": torch.from_numpy(g[f"frame{i}_bev"]).to(dev).double()}
        for k in TARGET_KEYS:
            dt = (torch.float64 if k in ("hm", "anno_box", "mask")
                  else torch.long)
            ex[k] = [torch.from_numpy(np.array(g[f"frame{i}_{k}{t}"]))
                     .to(dev, dt)[None] for t in range(len(tasks))]
        frames.append(ex)
    opt = OneCycleAdam(list(neck.parameters()) + list(head.parameters()),
                       lambda s: float(lrs[s]), lambda s: float(moms[s]),
                       weight_decay=0.01, grad_clip=35.0)
    neck.train()
    head.train()
    t0 = time.perf_counter()
    # cuDNN's float64 conv backward may add in no fixed order; the
    # deterministic algorithms give one curve in every run
    torch.use_deterministic_algorithms(True)
    try:
        losses = []
        for it in range(steps):
            ex = frames[it % n_frames]
            opt.zero_grad(set_to_none=True)
            loss, _ = center_head_loss(head(neck(ex["bev"])), ex, 0.25)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        losses = np.asarray([float(v) for v in losses])
    finally:
        torch.use_deterministic_algorithms(False)
    err = np.abs(losses - ref)
    tol = 1e-7 + 1e-13 * 1.5 ** np.arange(steps) + 1e-6 * ref
    res["det_train_golden"] = {"losses": losses.tolist(),
                               "ref_losses": ref.tolist(),
                               "max_err": float(err.max()),
                               "worst_share_of_tol": float((err / tol).max()),
                               "s": time.perf_counter() - t0}
    log(f"det_train_golden f64: {steps} steps, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (reference {ref[0]:.6f} -> {ref[-1]:.6f}), max "
        f"|err| {err.max():.3g}, worst {float((err / tol).max()):.3g} of its "
        f"bound at step {int((err / tol).argmax())}")
    if not (err <= tol).all():
        raise AssertionError(f"det_train_golden: max err {err.max()} at step "
                             f"{err.argmax()}")


class ConvLaunchSplit:
    """Counts, during one run, the calls of `window_conv` and `gather_conv`
    as `link_tpu_torch.sparse.conv` makes them, apart for the forward and
    the backward (a call made while autograd runs a graph task); every call
    still reaches the wrapper, which counts its launch."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import torch
        from link_tpu_torch.sparse import conv as sconv
        self._module, self._real = sconv, sconv.kernels
        real, calls = self._real, self.calls

        def counted(name):
            def call(*a, **kw):
                key = (name, "backward"
                       if torch._C._current_graph_task_id() >= 0
                       else "forward")
                calls[key] = calls.get(key, 0) + 1
                return getattr(real, name)(*a, **kw)
            return call

        class View:
            window_conv = staticmethod(counted("window_conv"))
            gather_conv = staticmethod(counted("gather_conv"))

            def __getattr__(self, name):
                return getattr(real, name)

        sconv.kernels = View()
        return self

    def __exit__(self, *exc):
        self._module.kernels = self._real
        return False


def phase_det_train_main(res, ctx, timed_steps=6):
    """det_train's default recipe at full width: CenterPoint-ELKv3 f32,
    one-cycle Adam, 2 synthetic frames a step at capacities (327,680,
    163,840, 81,920, 40,960) on the 1440 x 1440 x 40 grid; 1 warm and
    `timed_steps` timed steps."""
    import torch
    from link_tpu_torch.models.voxelnet import VoxelNet
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.train import det_trainer as DT
    from link_tpu_torch.train import schedules
    from link_tpu_torch.tools import det_train as tool

    batches = _det_train_batches(2)
    model = VoxelNet(batch_size=2, capacities=DET_TRAIN_CAPS, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    r = tool.RECIPE
    lr_fn, mom_fn = schedules.one_cycle(
        r["lr_max"], r["epochs"] * 4, moms=r["moms"],
        div_factor=r["div_factor"], pct_start=r["pct_start"])
    opt = DT.make_one_cycle_adam(model, lr_fn, mom_fn, weight_decay=r["wd"],
                                 grad_clip=r["clip"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(it):
        return DT.det_train_step(model, opt, batches[it % len(batches)])

    # as a user's det_train process runs: PyTorch's own TF32 flags (cuDNN's
    # float32 convolutions of the RPN and head on TF32); the hand kernels
    # run float32 as 3xTF32 either way
    with user_tf32():
        metrics = [step(0)]                                     # warm-up
        torch.cuda.synchronize()
        times = []
        for it in range(1, timed_steps + 1):
            if it == 1:
                kernels.reset_launch_counts()
                split = ConvLaunchSplit().__enter__()
            t0 = time.perf_counter()
            metrics.append(step(it))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if it == 1:
                split.__exit__()
                launches = {fn.__name__: fn.launches
                            for fn in kernels.KERNELS}
                builds = kernels.wgrad_work_list.builds
        peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step with TF32 off, as the parity gates run: its peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics.append(step(timed_steps + 1))
    torch.cuda.synchronize()
    res["det_train_tf32_off_ms"] = (time.perf_counter() - t0) * 1e3
    res["det_train_tf32_off_peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                             / 2**30)
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    nnz = [int(b["nnz"]) for b in batches]
    # 33 sparse convs with K > 1: 29 submanifold (7 at level 0, 16
    # channels, in the window form) and 4 strided. Forward: one launch
    # each; backward: one gather_wgrad each, and a feature gradient for
    # every conv but the stem, through the conv's own form. Joins: 4
    # submanifold levels, 4 strided plans, and level 0's ELK window: two
    # frames' level-0 lattice (1440 x 1440 x 41 x 2 cells) exceeds
    # coords.RANK_GRID_MAX_CELLS, so that block takes the sparse aux join
    # (as link_tpu decides), the others the dense aux grid
    want = {("window_conv", "forward"): 7, ("window_conv", "backward"): 6,
            ("gather_conv", "forward"): 26, ("gather_conv", "backward"): 26}
    want_launch = {"window_conv": 13, "gather_conv": 52, "gather_wgrad": 33,
                   "sorted_join": 9}
    res["det_train_launches"] = launches
    res["det_train_conv_split"] = {f"{k} {d}": v
                                   for (k, d), v in split.calls.items()}
    res["det_train_work_list_builds"] = builds
    res["det_train_losses"] = losses
    res["det_train_ms_per_step"] = times
    res["det_train_frames_per_s"] = 2 * len(times) / (sum(times) / 1e3)
    res["det_train_peak_mem_gb"] = peak
    res["det_train_nnz"] = nnz
    log(f"det train path f32, 2 frames a step ({nnz} voxels): ms per step "
        f"{[round(v, 1) for v in times]} (median "
        f"{float(np.median(times)):.1f}); "
        f"{res['det_train_frames_per_s']:.3f} training frames/s; launches "
        f"in one step {launches}; window_conv / gather_conv forward and "
        f"backward {res['det_train_conv_split']}; {builds} work lists "
        f"built; peak memory {res['det_train_peak_mem_gb']:.2f} GB (since "
        "the phase began, with the earlier phases' tensors held); one step "
        f"with TF32 off {res['det_train_tf32_off_ms']:.1f} ms, peak "
        f"{res['det_train_tf32_off_peak_mem_gb']:.2f} GB; loss per step "
        f"{[round(m['loss'], 4) for m in losses]}")
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"non-finite det training losses: {losses}")
    if (split.calls != want
            or any(launches[k] != v for k, v in want_launch.items())):
        raise AssertionError(f"det train launches {launches}, conv calls "
                             f"{split.calls}; expected {want_launch} and "
                             f"{want}")
    ctx.update(det_train_step=step, det_train_next=timed_steps + 2)


def phase_det_train_profile(res, ctx):
    from link_tpu_torch.sparse.coords import JOIN_RANGE
    from link_tpu_torch.train.det_trainer import RANGES
    step, it = ctx["det_train_step"], ctx["det_train_next"]
    with user_tf32():
        prof = _profile(lambda: step(it), 1,
                        float(np.median(res["det_train_ms_per_step"])),
                        "step", ranges=RANGES + (JOIN_RANGE,))
    res["det_train_profile"] = prof
    _check_join_sites(prof, "step", res["det_train_launches"]["sorted_join"])
    r = prof.get("ranges")
    if r and r[RANGES[0]]["device_ms"]:
        # autograd runs the backward's launches on its own thread: the
        # backward's device time is what the other two ranges leave
        fwd = r[RANGES[0]]["device_ms"]
        opt = r[RANGES[2]]["device_ms"] or 0.0
        bwd = prof["device_busy_ms_per_step"] - fwd - opt
        prof["device_ms_split"] = {"forward": fwd, "backward": bwd,
                                   "optimizer": opt}
        log(f"det train step device time: forward {fwd:.2f} ms, backward "
            f"{bwd:.2f} ms (busy minus the other two), optimizer "
            f"{opt:.2f} ms")


def phase_det_train_cli(res, ctx):
    """`python3 -m link_tpu_torch.tools.det_train --synthetic --epochs 1`
    in a fresh process: the default recipe on 8 synthetic frames, 4 steps;
    its log and metrics go to chiprun_out/det_train_run.* (the run dir,
    with a 130 MB checkpoint, under runs/ and removed after); the step's
    peak memory in a fresh process comes from its log."""
    import shutil
    run_dir = os.path.join(HERE, "runs", "chip_smoke_det_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "link_tpu_torch.tools.det_train",
           "--synthetic", "--epochs", "1", "--run-dir", run_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=DET_TRAIN_CLI_TIMEOUT)
    s = time.perf_counter() - t0
    out = os.path.join(HERE, "chiprun_out", "det_train_run")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines()[-6:]:
        log(f"det_train: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"det_train exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    shutil.copy(os.path.join(run_dir, "metrics.jsonl"), out + ".jsonl")
    shutil.rmtree(run_dir)
    with open(out + ".jsonl") as f:
        rec = [json.loads(line) for line in f][-1]
    res["det_train_cli"] = {"s": s, **rec}
    log(f"det_train --synthetic --epochs 1: {s:.1f} s, loss "
        f"{rec['loss/train']:.4f}, {rec['samples_per_sec']:.3f} frames/s "
        f"(data on the host included), peak memory {rec['peak_mem_gb']:.2f} "
        "GB in a fresh process")
    if not (rec["step"] == 4 and np.isfinite(rec["loss/train"])):
        raise AssertionError(f"det_train: {rec}")


def _launch_counts():
    from link_tpu_torch.ops import kernels
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def _near_pairs(kernels, cands, th):
    """Pairs of valid candidates whose kernel IoU lies within NEAR_THRESH of
    the threshold (`nms_candidates` of one frame)."""
    import torch
    near = 0
    for bx, _, _, vm in cands:
        iou = kernels.rotated_nms_iou(bx[0][:, [0, 1, 3, 4, 8]])
        v = vm[0]
        both = (v[:, None] & v[None, :]
                & ~torch.eye(len(v), dtype=torch.bool, device=v.device))
        near += int((both & ((iou - th).abs() < NEAR_THRESH)).sum()) // 2
    return near


def phase_det_files(res, ctx):
    """The det tools on the nuScenes-format files, on the card, at full
    width, under PyTorch's own TF32 flags (`user_tf32`), as a user's
    process runs them, in turn: `create_data gt_database` on the train
    infos; `det_train` without --synthetic, with --db-info-path, 2 epochs
    (the first with GT-AUG, stopped; the second resumed with --no-aug-from
    2, so without); `det_test` on its checkpoint over the val infos with
    host NMS, with --device-nms, with --double-flip and with --tt-rotation
    12.5 (mAP and NDS finite), and with the seed-0 weights (whose frames
    keep boxes) with host NMS, --device-nms and --tt-rotation 12.5;
    `tta_fuse --fuse-only` on the seed-0 rotation-0 and 12.5 JSONs; host
    and device NMS keep the same boxes from the same decode outputs but
    for pairs within NEAR_THRESH of the threshold (the det_serve rule), for
    both weights. Launch counts per tool run; the tools' output in
    chiprun_out/det_files.log."""
    with user_tf32():
        _det_files(res, ctx)


def _det_files(res, ctx):
    import contextlib
    import json as _json
    import shutil
    import tempfile
    from link_tpu_torch.inference import masked_rows
    from link_tpu_torch.models.center_head import device_nms, nms_candidates
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.tools import create_data, det_test, det_train
    from link_tpu_torch.tools import tta_fuse

    infos = _nus_tree(ctx)
    root = ctx["nus_root"]
    work = tempfile.mkdtemp(prefix="det_files_")
    out, launches = {}, {}
    kernels.reset_launch_counts()
    try:
        run_dir = os.path.join(work, "run")
        db_path = os.path.join(root, "dbinfos_train.pkl")
        train = ["--info-path", infos["train"], "--root-path", root,
                 "--db-info-path", db_path, "--epochs", "2", "--run-dir",
                 run_dir]
        ckpt = os.path.join(run_dir, "latest.pt")
        json_of = {}

        def test(name, *extra):
            json_of[name] = os.path.join(work, name + ".json")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            weights = [] if name.startswith("seed0") else ["--checkpoint",
                                                           ckpt]
            r = det_test.evaluate(det_test.parse_args(
                ["--info-path", infos["val"], "--root-path", root, *weights,
                 "--out", json_of[name], *extra]))
            r["s"] = time.perf_counter() - t0
            launches[f"det_test {name}"] = _launch_counts()
            return r

        os.makedirs(os.path.dirname(DET_FILES_LOG), exist_ok=True)
        with open(DET_FILES_LOG, "w") as logf, \
                contextlib.redirect_stdout(logf):
            t0 = time.perf_counter()
            db = create_data.build_gt_database(root, infos["train"],
                                               NUS_SWEEPS)
            out["gt_database"] = {"s": time.perf_counter() - t0,
                                  "classes": {k: len(v)
                                              for k, v in db.items()}}
            t0 = time.perf_counter()
            det_train.main(train + ["--stop-after-epoch", "1"])
            det_train.main(train + ["--resume", "auto", "--no-aug-from",
                                    "2"])
            out["train_s"] = time.perf_counter() - t0
            launches["det_train"] = _launch_counts()
            runs = {"host": test("host"),
                    "device": test("device", "--device-nms"),
                    "flip": test("flip", "--double-flip"),
                    "rot": test("rot", "--tt-rotation", "12.5"),
                    "seed0_host": test("seed0_host"),
                    "seed0_device": test("seed0_device", "--device-nms"),
                    "seed0_rot": test("seed0_rot", "--tt-rotation", "12.5")}
            t0 = time.perf_counter()
            tta_fuse.main(["--out-dir", os.path.join(work, "tta"),
                           "--fuse-only", json_of["seed0_host"],
                           json_of["seed0_rot"]])
            out["tta_fuse_s"] = time.perf_counter() - t0
            with open(os.path.join(work, "tta", "fused.json")) as f:
                fused = _json.load(f)
        text = open(DET_FILES_LOG).read()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            epochs = {r["epoch"]: r for r in map(_json.loads, f)
                      if "epoch" in r}
        out["epochs"] = epochs
        if (sorted(epochs) != [1, 2] or "resumed" not in text
                or [epochs[e]["gt_aug"] for e in (1, 2)] != [True, False]
                or not all(np.isfinite(r["loss/train"])
                           for r in epochs.values())):
            raise AssertionError(f"det_files: det_train epochs {epochs}")

        n_val = len(det_test.make_dataset(det_test.parse_args(
            ["--info-path", infos["val"]])))
        for name, r in runs.items():
            m = r["metrics"]
            out[name] = {"s": r["s"], "ms_per_frame": r["ms_per_frame"],
                         "mAP": m["mean_ap"], "NDS": m["nds"],
                         "kept": [len(s["pred_scores"])
                                  for s in r["samples"]]}
            if (len(r["samples"]) != n_val
                    or not np.isfinite([m["mean_ap"], m["nds"]]).all()
                    or not all(np.isfinite(s["pred_boxes"]).all()
                               for s in r["samples"])):
                raise AssertionError(f"det_files: det_test {name}: {out}")

        # host and device NMS on the same decode outputs (as det_serve: two
        # runs' forwards may differ in float rounding, which reorders the
        # many tied scores of the seed-0 weights): the same boxes, or a
        # pair near the threshold; for the checkpoint, whose 10 steps leave
        # few scores above the threshold, and the seed-0 weights, whose
        # frames keep 83 a task
        compare = []
        th = det_test.TEST_CFG["nms_iou_threshold"]
        for name, weights in (("checkpoint", ["--checkpoint", ckpt]),
                              ("seed0", [])):
            pargs = det_test.parse_args(["--info-path", infos["val"],
                                         *weights])
            run = det_test.DetTest(pargs, "cuda")
            ds = det_test.make_dataset(pargs)
            for f in range(len(ds)):
                outs = run.forward(run.batch(ds[f]))
                host = run.detections(masked_rows(outs))
                dev = masked_rows(device_nms(outs, run.cfg))
                dev = tuple(np.concatenate([r[i] for r in dev])
                            for i in range(3))
                same = all(np.array_equal(a, b) for a, b in zip(host, dev))
                near = 0 if same else _near_pairs(
                    kernels, nms_candidates(outs, run.cfg), th)
                compare.append({"weights": name, "frame": f,
                                "kept": len(host[1]), "equal": same,
                                "near_pairs": near})
                if not same and near == 0:
                    raise AssertionError(
                        f"det_files {name} frame {f}: host and device NMS "
                        "keep different boxes, and no pair lies near the "
                        "threshold")
        for pre in ("", "seed0_"):
            out[pre + "cli_runs_equal"] = all(
                np.array_equal(a[k], b[k])
                for a, b in zip(runs[pre + "host"]["samples"],
                                runs[pre + "device"]["samples"])
                for k in ("pred_boxes", "pred_scores", "pred_labels"))
        out["host_vs_device"] = compare

        want_nms = n_val * kernels.ROTATED_NMS_LAUNCHES
        for name, cnt in launches.items():
            need = ("sorted_join", "gather_conv", "window_conv") + (
                ("gather_wgrad",) if name == "det_train" else ())
            if min(cnt[k] for k in need) == 0 or cnt["rotated_nms"] != (
                    want_nms if name.endswith("device") else 0):
                raise AssertionError(f"det_files: {name} launches {cnt}")
        if (len(fused) != n_val or not all(
                np.all(np.diff(r["pred_scores"]) <= 0) for r in fused)
                or not any(len(r["pred_scores"]) for r in fused)):
            raise AssertionError(f"det_files: tta_fuse wrote {len(fused)} "
                                 f"records of {n_val}")
        out["fused_kept"] = [len(r["pred_scores"]) for r in fused]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["det_files"] = out
    res["det_files_launches"] = {
        k: sum(cnt[k] for cnt in launches.values())
        for k in next(iter(launches.values()))}
    res["det_files_launches_by_tool"] = launches
    ms_step = {e: 2e3 / r["samples_per_sec"] for e, r in epochs.items()}
    log(f"det_files: gt_database {out['gt_database']}; det_train epochs "
        f"{[(e, round(r['loss/train'], 4), r['gt_aug']) for e, r in epochs.items()]}"
        f" (loss, GT-AUG; epoch 2 resumed), ms per step (data on the host "
        f"included) {[round(v, 1) for v in ms_step.values()]}, "
        f"{out['train_s']:.1f} s; det_test "
        + "; ".join(f"{k}: mAP {out[k]['mAP']:.4f} NDS {out[k]['NDS']:.4f} "
                    f"ms per frame {[round(v, 1) for v in out[k]['ms_per_frame']]}"
                    f" kept {out[k]['kept']}"
                    for k in runs)
        + f"; host vs device NMS {compare}; tta_fuse kept "
        f"{out['fused_kept']}; launches {launches}")


# --------------------------------------------------------------------------
# the conv kernels at every shape of the main paths


class ShapeRecorder:
    """Stands in for the kernels module as `link_tpu_torch.sparse.conv`
    and `link_tpu_torch.sparse.coords` see it, during one run of a main
    path: every call reaches the kernel as before, and the arguments of the
    first `gather_conv`, `gather_wgrad` and `window_conv` call of each
    distinct shape and dtype are kept, with the number of calls of each
    (`conv_calls`, `wgrad_calls`), and those of every `sorted_join` call
    (`joins`)."""

    def __init__(self):
        self.conv, self.wgrad, self.window = {}, {}, {}
        self.conv_calls, self.wgrad_calls = {}, {}
        self.joins = []

    def __enter__(self):
        from types import SimpleNamespace
        from link_tpu_torch.sparse import conv as sconv
        from link_tpu_torch.sparse import coords as scoords
        self._modules, self._real = (sconv, scoords), sconv.kernels
        real, rec = self._real, self

        class View:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def gather_conv(feats, idx, weight):
                key = (tuple(feats.shape), tuple(idx.shape),
                       tuple(weight.shape), str(feats.dtype))
                # detached: a training step's tensors need no graph here
                rec.conv.setdefault(key, (feats.detach(), idx,
                                          weight.detach()))
                rec.conv_calls[key] = rec.conv_calls.get(key, 0) + 1
                return real.gather_conv(feats, idx, weight)

            @staticmethod
            def gather_wgrad(feats, g, bwd_idx, work=None):
                key = (tuple(feats.shape), tuple(g.shape),
                       tuple(bwd_idx.shape), str(feats.dtype))
                rec.wgrad.setdefault(key, (feats.detach(), g.detach(),
                                           bwd_idx, work))
                rec.wgrad_calls[key] = rec.wgrad_calls.get(key, 0) + 1
                return real.gather_wgrad(feats, g, bwd_idx, work)

            @staticmethod
            def window_conv(feats, base_pos, slot, groups, weight):
                key = (tuple(feats.shape), tuple(slot.shape),
                       tuple(weight.shape), str(feats.dtype), groups)
                rec.window.setdefault(key, (feats.detach(), SimpleNamespace(
                    base_pos=base_pos, slot=slot, groups=groups),
                    weight.detach()))
                return real.window_conv(feats, base_pos, slot, groups,
                                        weight)

            @staticmethod
            def sorted_join(t_hi, t_lo, perm, base, offsets=None, mult=None,
                            mode="exact"):
                rec.joins.append((t_hi, t_lo, perm, base, offsets, mult,
                                  mode))
                return real.sorted_join(t_hi, t_lo, perm, base, offsets,
                                        mult, mode)

        view = View()
        for mod in self._modules:
            mod.kernels = view
        return self

    def __exit__(self, *exc):
        for mod in self._modules:
            mod.kernels = self._real
        return False


class JoinRecorder:
    """Records, during one run of a family's pass, the arguments of every
    `sorted_join` call made inside the new join sites: `upsample_voxel`
    (ELKEncoder) and `voxel_to_point` / `point_to_voxel` (SPVCNN). Each
    site function is wrapped where the model calls it, and the kernels
    module as `link_tpu_torch.sparse.coords` sees it records while a site
    runs; every call still reaches the kernel."""

    SITES = (("link_tpu_torch.models.linkencoder", "upsample_voxel"),
             ("link_tpu_torch.models.spvcnn", "voxel_to_point"),
             ("link_tpu_torch.models.spvcnn", "point_to_voxel"))

    def __init__(self):
        self.calls = []          # (site, args of sorted_join)
        self._site = None

    def __enter__(self):
        import importlib
        from link_tpu_torch.sparse import coords as C
        rec, real = self, C.kernels
        self._patched = [(C, "kernels", real)]

        class View:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def sorted_join(t_hi, t_lo, perm, base, offsets=None, mult=None,
                            mode="exact"):
                if rec._site is not None:
                    rec.calls.append((rec._site, (t_hi, t_lo, perm, base,
                                                  offsets, mult, mode)))
                return real.sorted_join(t_hi, t_lo, perm, base, offsets,
                                        mult, mode)

        C.kernels = View()
        for mod_name, fn_name in self.SITES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self._patched.append((mod, fn_name, fn))

            def site(st, other, *a, _fn=fn, _name=fn_name, **kw):
                rec._site = f"{_name} stride {st.stride[0]}"
                try:
                    return _fn(st, other, *a, **kw)
                finally:
                    rec._site = None

            setattr(mod, fn_name, site)
        return self

    def __exit__(self, *exc):
        for mod, name, value in self._patched:
            setattr(mod, name, value)
        return False


def _unsorted_warp_share(kernels, base) -> float:
    """Share of `sorted_join`'s warps (32 consecutive base rows, one per
    lane) whose rows' keys are out of order, so that the warp searches the
    whole table per lane instead of bracketing (csrc/sorted_join.cu)."""
    hi, lo = kernels.pack_coords(base)
    key = kernels.key64(hi, lo)
    w = key[:key.shape[0] // 32 * 32].view(-1, 32)
    return float((w[:, 1:] < w[:, :-1]).any(1).float().mean())


def phase_path_shapes(res, ctx, iters=10):
    """`gather_conv` and `gather_wgrad` against their twins, bit-equal over
    two runs and timed, at every distinct shape that one more seg pass, det
    pass, seg training step and det training step give them (their inputs
    as the paths make them;
    recorded here, so that the earlier phases' counts, times and peak memory
    are the paths' own), and each work list of the step against its plain
    twin. Then one more pass of each seg family: `gather_conv` at every
    (K, Ci, Co, dtype) that no earlier path gives it, and `sorted_join` at
    every call of the families' new join sites, exactly."""
    import torch
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.sparse.coords import CoordTable
    model, scans, fresh = ctx["model"], ctx["scans"], ctx["fresh"]
    recorders = {}
    with torch.inference_mode(), ShapeRecorder() as recorders["seg"]:
        model(fresh(scans[0]))
    with ShapeRecorder() as recorders["det"]:
        ctx["pred"].forward(ctx["det_batches"][0])
    with ShapeRecorder() as recorders["train"]:
        ctx["train_step"](ctx["train_next"] + 1)
    with ShapeRecorder() as recorders["det_train"]:
        ctx.pop("det_train_step")(ctx["det_train_next"] + 1)
    fam_conv, fam_join = {}, {}
    for name, (_, fmodel) in ctx["families"].items():
        with (torch.inference_mode(), ShapeRecorder() as fam_conv[name],
              JoinRecorder() as fam_join[name]):
            fmodel(fresh(scans[0]))
    torch.cuda.synchronize()
    conv_cases, wgrad_cases = [], []
    for path, rec in recorders.items():
        for feats, idx, weight in rec.conv.values():
            conv_cases.append(_conv_case(kernels, feats, idx, weight, iters,
                                         role=path))
        for feats, g, bwd, work in rec.wgrad.values():
            twin = kernels.wgrad_work_list_plain(bwd)
            total = int(twin.tap_off[-1])
            if work is not None and not (
                    torch.equal(work.tap_off, twin.tap_off)
                    and torch.equal(work.hit_i[:total], twin.hit_i[:total])
                    and torch.equal(work.hit_j[:total], twin.hit_j[:total])):
                raise AssertionError(f"{path}: a work list differs from its "
                                     "plain twin")
            wgrad_cases.append(_wgrad_case(kernels, feats, g, bwd, iters,
                                           work, role=path))
    res["path_conv_cases"] = conv_cases
    res["path_wgrad_cases"] = wgrad_cases
    log(f"path shapes: gather_conv at {len(conv_cases)} and gather_wgrad at "
        f"{len(wgrad_cases)} distinct shapes of the four paths, each within "
        "its tolerance and bit-equal over two runs; "
        f"{len(CAPTURE_FAILED)} failed graph captures so far")

    def kco(key):                     # (K, Ci, Co, dtype) of a recorder key
        return (key[1][0], key[0][1], key[2][-1], key[3])

    seen = {kco(k) for rec in recorders.values() for k in rec.conv}
    fam_cases = []
    for name, rec in fam_conv.items():
        calls = {}
        for key, n in rec.conv_calls.items():
            calls[kco(key)] = calls.get(kco(key), 0) + n
        for key, (feats, idx, weight) in rec.conv.items():
            if kco(key) in seen:
                continue
            seen.add(kco(key))
            case = _conv_case(kernels, feats, idx, weight, iters, role=name)
            case["launches_per_scan"] = calls[kco(key)]
            fam_cases.append(case)
    join_cases = []
    for name, rec in fam_join.items():
        for site, (hi, lo, perm, base, offs, mult, mode) in rec.calls:
            case = _join_case(kernels, CoordTable(hi, lo, perm), base, offs,
                              mode, iters, mult=mult, role=f"{name} {site}")
            case["unsorted_warp_share"] = _unsorted_warp_share(kernels, base)
            log(f"  {case['role']}: {case['unsorted_warp_share']:.3f} of its "
                "warps hold base rows out of key order")
            join_cases.append(case)
    sites = sorted(c["role"] for c in join_cases)
    want = sorted([f"linkencoder upsample_voxel stride {s}"
                   for s in (2, 4, 8, 16)]
                  + [f"spvcnn voxel_to_point stride {s}" for s in (1, 4, 16)]
                  + [f"spvcnn point_to_voxel stride {s}" for s in (4, 16)])
    res["family_conv_cases"] = fam_cases
    res["family_join_cases"] = join_cases
    log(f"family shapes: gather_conv at {len(fam_cases)} new (K, Ci, Co, "
        f"dtype), each within its tolerance and bit-equal over two runs; "
        f"sorted_join at the {len(join_cases)} new join sites of a pass, "
        "each equal to its twin")
    if sites != want:
        raise AssertionError(f"family join sites {sites}, expected {want}")
    _family_train_shapes(res, ctx, kernels, recorders, iters)
    _tta_shapes(res, ctx, kernels)


def _family_train_shapes(res, ctx, kernels, recorders, iters):
    """`gather_conv` and `gather_wgrad` at every distinct shape of one more
    training step of each seg family (`seg_families_train`), on the step's
    own inputs (a shape an earlier path also gives them is held again): the
    conv against its twin, `gather_wgrad` against the float64 sum, each
    bit-equal over two runs and timed beside its bound, with its launches
    per step."""
    import torch
    earlier = ({k for rec in recorders.values() for k in rec.conv}
               | {k for rec in recorders.values() for k in rec.wgrad})
    conv_cases, wgrad_cases = [], []
    for name, step in ctx.pop("family_train").items():
        with ShapeRecorder() as rec:
            step(ctx["family_train_next"])
        torch.cuda.synchronize()
        for key, (feats, idx, weight) in rec.conv.items():
            case = _conv_case(kernels, feats, idx, weight, iters,
                              role=f"{name} training")
            case["launches_per_step"] = rec.conv_calls[key]
            case["new_shape"] = key not in earlier
            conv_cases.append(case)
        for key, (feats, g, bwd, work) in rec.wgrad.items():
            case = _wgrad_case(kernels, feats, g, bwd, iters, work,
                               role=f"{name} training")
            case["launches_per_step"] = rec.wgrad_calls[key]
            case["new_shape"] = key not in earlier
            wgrad_cases.append(case)
        del rec
        torch.cuda.empty_cache()
    res["family_train_conv_cases"] = conv_cases
    res["family_train_wgrad_cases"] = wgrad_cases
    worst = max((c["rel_err"] for c in wgrad_cases), default=float("nan"))
    new = sum(c["new_shape"] for c in conv_cases + wgrad_cases)
    log(f"family training shapes: gather_conv at {len(conv_cases)} and "
        f"gather_wgrad at {len(wgrad_cases)} shapes of the three families' "
        f"steps ({new} met on no earlier path), each within its tolerance "
        f"and bit-equal over two "
        f"runs (gather_wgrad's worst against the float64 sum {worst:.3g}); "
        f"kernel / bound: gather_conv "
        f"{sum(c['ms'] for c in conv_cases):.3f} / "
        f"{sum(c['bound_ms'] for c in conv_cases):.3f} ms, gather_wgrad "
        f"{sum(c['ms'] for c in wgrad_cases):.3f} / "
        f"{sum(c['bound_ms'] for c in wgrad_cases):.3f} ms over the shapes")
    if not conv_cases or not wgrad_cases:
        raise AssertionError("the families' training steps gave the "
                             "kernels no shapes")


# --------------------------------------------------------------------------
# probe tool


def phase_probes(res, ctx):
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.tools.probe_gather import Probes

    kernels.reset_launch_counts()
    probes = Probes("cuda", iters=8, reps=3, log=log)
    cases = probes.run()
    # row 4c and the empty launch against their library calls: 6
    # interleaved readings each (kernel, library, library, kernel, ...)
    res["probe_readings"] = probes.readings(6)
    res["probe_launches"] = {fn.__name__: fn.launches
                             for fn in kernels.KERNELS}
    res["probe_cases"] = cases
    log(f"probes: {len(cases)} cases, each exact against its twin, and "
        f"{len(res['probe_readings'])} interleaved comparisons; launches "
        f"{ {k: v for k, v in res['probe_launches'].items() if v} } (per "
        "case: one compared with the twin, one warm, 8 x 3 timed)")
    if min(res["probe_launches"][k] for k in
           ("probe_row_gather", "probe_slab_copy", "probe_empty")) == 0:
        raise AssertionError("a probe kernel was not launched")
    # the kernels' edges against their twins, after the counted run
    edges = probes.edges()
    res["probe_edges"] = edges
    log(f"probe edges: {len(edges)} cases, each bit-equal against its twin")


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
    # 512 slabs of 512 rows of 256 B (128 KB each, in stage-sized chunks)
    "probe_slab_copy": lambda res: _probe_case(
        res, "probe_slab_copy", letter="D", g=512),
    "probe_empty": lambda res: _probe_case(res, "probe_empty"),
    # frame 0's call over its 6 tasks: the top 1,000 candidates each,
    # thresh 0.2, cap 83
    "rotated_nms": lambda res: res["rotated_nms_case"],
}
MAIN_PATHS = {"seg": "launches",
              **{f"seg_{name}": f"family_launches_{name}" for name in FAMILIES},
              **{f"train_{name}": f"family_train_launches_{name}"
                 for name in FAMILIES},
              "det": "det_launches", "det_serve": "det_serve_launches",
              "det_tta": "det_tta_launches",
              "det_files": "det_files_launches",
              "train": "train_launches", "det_train": "det_train_launches",
              "probes": "probe_launches"}


def kernels_line(res):
    """One entry per kernel of `kernels.KERNELS` (name, source and what it
    replaces come from that registry): launches summed over the main paths'
    counted runs (one seg pass of 4 scans, one pass of the same 4 scans of
    each other seg family, one det pass of 2 frames, one
    device-NMS `predict` of the 2 frames, one double-flip pass of 2 val
    frames, the det tools' runs on the nuScenes-format files, one train
    step, one training step of each other seg family, one det train step,
    one run of the probe tool), and the error, times and bound
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
    USER_TF32.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                     cudnn=torch.backends.cudnn.allow_tf32)
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
                  phase_profile, phase_seg_families_golden,
                  phase_seg_families_main, phase_seg_families_hold,
                  phase_seg_families_eval, phase_det_kernels, phase_det_golden,
                  phase_det_elk_golden, phase_det_main, phase_det_profile,
                  phase_det_nms_kernels, phase_det_serve,
                  phase_det_flip_golden, phase_det_tta_main,
                  phase_train_kernels, phase_train_grad, phase_train_golden,
                  phase_train_main, phase_train_profile,
                  phase_seg_families_train, phase_seg_families_train_grad,
                  phase_seg_files, phase_det_train_kernels,
                  phase_det_train_grad, phase_det_train_golden,
                  phase_det_train_main,
                  phase_det_train_profile, phase_det_train_cli,
                  phase_det_files,
                  phase_path_shapes, phase_probes):
        t0 = time.perf_counter()
        phase(res, ctx)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    res["total_s"] = time.perf_counter() - t_start
    res["capture_failed"] = CAPTURE_FAILED

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
