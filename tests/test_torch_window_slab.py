"""The row-span design of `window_conv`, emulated on the CPU on a real det
level-0 window plan.

The kernel (link_tpu_torch/csrc/window_conv.cu) walks 16-row output tiles;
for each group with a hit it copies one contiguous span of table rows,
[min base, max base + G - 1] over the tile's rows with a hit, capped at S =
`kernels.WINDOW_SPAN_ROWS` rows, into shared memory, reads a window row
outside the span from the table itself, routes each row's slots from the
span into an A tile of 16 x (G * CiP) (zero for a miss, CiP = Ci rounded up
to the MMA depth), multiplies it with the group's stacked weights (G * CiP)
x Co, starts each group's chain from zero and adds it into the float32
sum in group order. These tests build the det backbone's level-0
submanifold window plan from a crop of one synthetic nuScenes frame (its
voxels in the central 256 x 256-cell square of the 1440 x 1440 grid, so
the density of neighbours is the real one at a small capacity), then:

  * count the tiles whose base rows are not nondecreasing (the property the
    span rests on) and the window rows that fall outside a capped span;
  * emulate the kernel in torch, in float64 and in its float32 order, and
    hold it to `window_conv_plain` and to JAX's `_win_apply_impl`
    (link_tpu/sparse/conv.py:478) on the same numpy inputs: max|err| /
    max|ref| < 1e-5, the same products summed in another order;
  * emulate the float32 product as the kernel runs it on the tensor cores:
    three TF32 passes stay under the 1e-5 bound, one pass does not.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.sparse import conv as jconv
from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.data.nuscenes import SyntheticNuScenes
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.conv import add_window_form, build_conv_plan

from test_torch_tf32_split import tf32

F32_TOL = 1e-5       # a float32 kernel against its twin (chip_smoke.py)
TILE = 16            # output rows per warp tile (window_conv.cu, MT)
CROP = 256           # grid cells of the square crop in x and y
CAP = 8192           # rows of the cropped level


@pytest.fixture(scope="module")
def det_plan():
    """The level-0 window plan of the cropped frame: (plan, nnz)."""
    s = SyntheticNuScenes(length=1, mode="val", seed=0, max_voxels=160000)[0]
    zyx = s["coords_zyx"]
    centre = 720                                # of the 1440-cell grid
    keep = ((np.abs(zyx[:, 2] - centre) < CROP // 2)
            & (np.abs(zyx[:, 1] - centre) < CROP // 2))
    crop = {"voxels": s["voxels"][keep], "coords_zyx": zyx[keep],
            "num_points": s["num_points"][keep]}
    batch = dp.collate_det([crop], CAP)
    # pack-key order, as the backbone's level tables keep their rows
    coords = torch.from_numpy(batch["coords"])
    nnz = int(batch["nnz"])
    hi, lo = C.pack_coords(coords)
    order = torch.argsort(kernels.key64(hi, lo))
    coords = coords[order].contiguous()
    offs = C.kernel_offsets_np(3)
    table = C.build_table(coords, assume_sorted=True)
    plan = add_window_form(
        build_conv_plan(coords, coords, torch.tensor(nnz, dtype=torch.int32),
                        offs, CAP, in_sorted=True, table=table),
        table, offs, 1)
    return plan, nnz


def _weights(k, ci, co, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((CAP, ci)).astype(np.float32)
    w = (rng.standard_normal((k, ci, co)) / np.sqrt(27 * ci)).astype(
        np.float32)
    return feats, w


def emulate(feats, base_pos, slot, groups, w, span_rows, product,
            acc_dtype):
    """The kernel's row-span algorithm in torch. `product(a, b)` is one
    group's (T, 16, G * CiP) x (G * CiP, Co) product, summed into the
    accumulator of `acc_dtype` in group order. Returns (out (M, Co),
    window rows read from the table because they fell outside the
    span)."""
    n, ci = feats.shape
    k, m = slot.shape
    co = w.shape[2]
    gw = max(len(t) for t in groups)
    cip = -(-ci // 8) * 8                       # m16n8k8: depth 8
    tiles = -(-m // TILE)
    pad = tiles * TILE - m
    slot = torch.cat([slot.long(), torch.full((k, pad), -1)], 1)
    base_pos = torch.cat([base_pos.long(), torch.zeros(
        (base_pos.shape[0], pad), dtype=torch.long)], 1)
    f = torch.zeros((n, cip), dtype=feats.dtype)
    f[:, :ci] = feats
    acc = torch.zeros((tiles, TILE, co), dtype=acc_dtype)
    outside = 0
    ar = torch.arange(span_rows)
    for gi, taps in enumerate(groups):
        s = slot[list(taps)].reshape(len(taps), tiles, TILE)
        ok = (s >= 0) & (s < gw)
        b = base_pos[gi].reshape(tiles, TILE)
        hit = ok.any(0)                                      # (T, 16)
        active = hit.any(1)
        big = torch.iinfo(torch.long).max
        lo = torch.where(hit, b, big).amin(1)
        hi = torch.where(hit, b, -big).amax(1)
        rows = torch.where(active, (hi - lo + gw).clamp(max=span_rows), 0)
        lo = torch.where(active, lo, 0)
        # the staged span, zero past `rows`, past the table and past Ci,
        # and one zero row at its end (a miss reads it)
        src = lo[:, None] + ar[None, :]
        staged = (ar[None, :] < rows[:, None]) & (src >= 0) & (src < n)
        buf = torch.zeros((tiles, span_rows + 1, cip), dtype=feats.dtype)
        buf[:, :span_rows] = torch.where(
            staged[..., None], f[src.clamp(0, n - 1)], 0)
        a = torch.zeros((tiles, TILE, gw * cip), dtype=feats.dtype)
        wg = torch.zeros((gw * cip, co), dtype=w.dtype)
        for j, t in enumerate(taps):
            row = b + s[j]
            live = ok[j] & (row >= 0) & (row < n)
            inspan = live & (row >= lo[:, None]) & (row - lo[:, None]
                                                     < rows[:, None])
            code = torch.where(inspan, row - lo[:, None], span_rows)
            from_span = buf[torch.arange(tiles)[:, None], code]
            from_table = torch.where((live & ~inspan)[..., None],
                                     f[row.clamp(0, n - 1)], 0)
            a[:, :, j * cip:(j + 1) * cip] = from_span + from_table
            outside += int((live & ~inspan).sum())
            wg[j * cip:j * cip + ci] = w[t]
        chain = product(a, wg).to(acc_dtype)
        acc += torch.where(active[:, None, None], chain, 0)
    return acc.reshape(tiles * TILE, co)[:m], outside


def _f64(a, b):
    return a.double() @ b.double()


def _f32(a, b):
    return a.float() @ b.float()


def _tf32(x):
    return torch.from_numpy(tf32(x.numpy()))


def _one_pass(a, b):
    return _tf32(a).double() @ _tf32(b).double()


def _three_pass(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
            + a_hi.double() @ b_hi.double())


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_the_crop_has_the_level_zero_density(det_plan):
    """About one hit per row and tap group pattern of the full frame (the
    full level 0 reads 188,484 hits over 160,000 voxels, 1.18 per voxel)."""
    plan, nnz = det_plan
    assert 2000 < nnz < CAP
    assert plan.slot.shape == (27, CAP) and plan.base_pos.shape == (9, CAP)
    per_voxel = int((plan.slot >= 0).sum()) / nnz
    assert 1.02 < per_voxel < 1.6
    assert plan.window == 3 and plan.groups is not None


@pytest.mark.parametrize("tile_rows", [TILE, 64])
def test_base_rows_are_nondecreasing_in_every_tile(det_plan, tile_rows):
    """Rows are sorted, so each group's base rows never step back within a
    tile: the rows a tile reads for one group are one contiguous span."""
    plan, _ = det_plan
    b = plan.base_pos.long()
    steps = b.reshape(b.shape[0], -1, tile_rows).diff(dim=2)
    assert int((steps < 0).any(2).sum()) == 0


def test_window_rows_outside_the_capped_span(det_plan):
    """Hits whose window row lies past the first S rows of their tile's
    span, for the kernel's S and smaller caps: none at S, and a cap of
    one tile's rows would miss some."""
    plan, _ = det_plan
    k, m = plan.slot.shape
    feats = torch.zeros((CAP, 8))
    w = torch.zeros((k, 8, 8))
    counts = {}
    for cap in (TILE, 32, kernels.WINDOW_SPAN_ROWS):
        _, counts[cap] = emulate(feats, plan.base_pos, plan.slot,
                                 plan.groups, w, cap, _f32, torch.float32)
    assert counts[kernels.WINDOW_SPAN_ROWS] == 0
    assert counts[TILE] > 0
    assert counts[TILE] >= counts[32] >= counts[kernels.WINDOW_SPAN_ROWS]


@pytest.mark.parametrize("ci,co", [(16, 16), (5, 16)])
def test_emulated_kernel_matches_twin_and_jax(det_plan, ci, co):
    """float64 and float32-order emulation (with S = 4 rows, so that a
    quarter of the rows take the read-from-the-table path too) against
    `window_conv_plain` and `_win_apply_impl`."""
    plan, _ = det_plan
    k = plan.slot.shape[0]
    feats, w = _weights(k, ci, co, seed=ci)
    tf, tw = torch.from_numpy(feats), torch.from_numpy(w)
    twin = kernels.window_conv_plain(tf, plan.base_pos, plan.slot,
                                     plan.groups, tw).numpy()
    want = np.asarray(jconv._win_apply_impl(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(plan.base_pos.numpy()),
        jnp.asarray(plan.slot.numpy()), plan.groups, plan.self_group),
        np.float32)
    assert _rel(twin, want) < F32_TOL
    for span_rows in (kernels.WINDOW_SPAN_ROWS, 4):
        e64, out64 = emulate(tf, plan.base_pos, plan.slot, plan.groups, tw,
                             span_rows, _f64, torch.float64)
        e32, out32 = emulate(tf, plan.base_pos, plan.slot, plan.groups, tw,
                             span_rows, _f32, torch.float32)
        assert out64 == out32
        assert (out64 > 0) == (span_rows == 4)
        for got in (e64, e32):
            assert _rel(got.numpy(), twin) < F32_TOL
            assert _rel(got.numpy(), want) < F32_TOL


def test_three_tf32_passes_meet_the_bound_where_one_does_not(det_plan):
    plan, _ = det_plan
    k = plan.slot.shape[0]
    feats, w = _weights(k, 16, 16, seed=3)
    tf, tw = torch.from_numpy(feats), torch.from_numpy(w)
    args = (tf, plan.base_pos, plan.slot, plan.groups, tw,
            kernels.WINDOW_SPAN_ROWS)
    ref, _ = emulate(*args, _f64, torch.float64)
    one, _ = emulate(*args, _one_pass, torch.float32)
    three, _ = emulate(*args, _three_pass, torch.float32)
    assert _rel(one.numpy(), ref.numpy()) > F32_TOL
    assert _rel(three.numpy(), ref.numpy()) < F32_TOL


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_the_kernel_copies_spans_async_and_multiplies_on_tensor_cores():
    """window_conv.cu stages spans with cp.async, multiplies with
    `mma_3xtf32` (float32) and `mma_bf16` (bfloat16) and nothing else, and
    keeps S in step with `kernels.WINDOW_SPAN_ROWS`."""
    src = _strip_comments(open(os.path.join(kernels.CSRC,
                                            "window_conv.cu")).read())
    assert '#include "mma_sm90.cuh"' in src
    assert "copy.piece(" in src and "cp_async<16>(" in src
    assert "mma_3xtf32(" in src and "mma_bf16(" in src
    assert "mma_tf32(" not in src and "tf32.tf32" not in src
    assert "fmaf(" not in src and "atomic" not in src
    assert re.search(r"constexpr int S = (\d+);", src).group(1) == str(
        kernels.WINDOW_SPAN_ROWS)
