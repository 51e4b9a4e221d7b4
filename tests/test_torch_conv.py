"""Port vs JAX: the gather-matmul conv twin, kernel maps and conv3d.

Inputs come from numpy seeds and go through both packages. Kernel maps are
integers and compared exactly. Float32 outputs are compared as
max|port - ref| / max|ref| < 1e-5: the same products are summed in another
order. bfloat16 outputs: both sides sum exact bf16 products in float32 and
round once to bf16, so they differ by at most one bf16 ulp (2^-8 relative)
where the order moves a sum across a rounding boundary; bound 8e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from link_tpu.ops import pallas_kernels as pk
from link_tpu.sparse import conv as jconv
from link_tpu.sparse import coords as jc
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as tc
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
BF16_TOL = 8e-3


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _sorted_cloud(rng, n, span, nb=2):
    """Clustered unique coords (random walks, so neighbours exist) in
    pack-key order."""
    steps = rng.integers(-1, 2, (n, 3))
    walk = np.cumsum(steps, 0) % span
    b = np.sort(rng.integers(0, nb, n))
    pts = np.unique(np.concatenate([walk, b[:, None]], 1).astype(np.int32),
                    axis=0)
    order = np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]))
    return pts[order]


def _padded(coords, feats, cap):
    n = len(coords)
    cp = np.full((cap, 4), jc.INVALID_COORD, np.int32)
    fp = np.zeros((cap, feats.shape[1]), np.float32)
    cp[:n], fp[:n] = coords, feats
    return cp, fp, n


def _pair(coords, feats, cap, extent=None):
    cp, fp, n = _padded(coords, feats, cap)
    js = j_make(fp, cp, nnz=n, base_sorted=True, grid_extent=extent)
    ts = t_make(fp, cp, nnz=n, base_sorted=True, grid_extent=extent,
                device="cpu")
    return js, ts, n


@pytest.mark.parametrize("ci,co,k,dtype", [
    (4, 16, 27, "float32"), (16, 24, 8, "float32"), (32, 16, 27, "float32"),
    (16, 16, 27, "bfloat16"), (4, 16, 27, "bfloat16")])
def test_conv_twin_matches_pallas_conv_and_gm_impl(ci, co, k, dtype):
    rng = np.random.default_rng(ci * 100 + k)
    n, m = 300, 260
    feats = rng.standard_normal((n, ci)).astype(np.float32)
    idx = rng.integers(-1, n, (k, m)).astype(np.int32)
    idx[rng.random((k, m)) < 0.4] = -1                 # misses read zero rows
    idx[:, :7] = -1                                    # all-miss columns
    w = (rng.standard_normal((k, ci, co)) / np.sqrt(ci * k)).astype(np.float32)

    jdt = jnp.dtype(dtype)
    jf, jw = jnp.asarray(feats, jdt), jnp.asarray(w, jdt)
    want_pallas = np.asarray(pk.pallas_sparse_conv(
        jf, jnp.asarray(idx), jw, block_m=128, interpret=True), np.float32)
    want_gm = np.asarray(jconv._gm_impl(jf, jw, jnp.asarray(idx)), np.float32)

    tdt = getattr(torch, dtype)
    got = tk.gather_conv(torch.from_numpy(feats).to(tdt), torch.from_numpy(idx),
                         torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (m, co)
    got = got.float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got, want_pallas) < tol
    assert _rel(got, want_gm) < tol
    np.testing.assert_array_equal(got[:7], 0.0)


PLAN_SEEDS = {"submanifold": 10, "strided": 20, "coarse_subm": 30}


def _plan_case(kind, extent):
    rng = np.random.default_rng(PLAN_SEEDS[kind] + bool(extent))
    coords = _sorted_cloud(rng, 700, span=12)
    feats = rng.standard_normal((len(coords), 8)).astype(np.float32)
    ext = (12, 12, 12, 2) if extent else None
    return _pair(coords, feats, len(coords) + 37, ext)


@pytest.mark.parametrize("extent", [False, True])
@pytest.mark.parametrize("kind", ["submanifold", "strided", "coarse_subm"])
def test_plan_in_idx_matches_jax(kind, extent):
    """in_idx of the port's grouped join equals the JAX plan, which takes
    its grouped DirectIndex path without grid_extent and its RankGrid path
    with it; strided plans also carry an eager inverse map."""
    js, ts, _ = _plan_case(kind, extent)
    w3 = np.zeros((27, 8, 8), np.float32)
    w2 = np.zeros((8, 8, 8), np.float32)
    if kind == "submanifold":
        key = ("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))
        jconv.conv3d(js, jnp.asarray(w3), 3)
        tconv.conv3d(ts, torch.from_numpy(w3), 3)
    else:
        jd = jconv.conv3d(js, jnp.asarray(w2), 2, stride=2, out_capacity=400)
        td = tconv.conv3d(ts, torch.from_numpy(w2), 2, stride=2,
                          out_capacity=400)
        key = ("plan", (1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1))
        if kind == "coarse_subm":
            jconv.conv3d(jd, jnp.asarray(w3), 3)
            tconv.conv3d(td, torch.from_numpy(w3), 3)
            key = ("plan", (2, 2, 2), (3, 3, 3), (1, 1, 1), (1, 1, 1))
    jp, tp = js.kmaps[key], ts.kmaps[key]
    jtab = js.kmaps[("table", key[1])]
    assert (jtab.grid is not None) == extent
    assert (jtab.direct is not None) == (not extent)
    np.testing.assert_array_equal(tp.in_idx.numpy(), np.asarray(jp.in_idx))
    np.testing.assert_array_equal(tp.out_coords.numpy(),
                                  np.asarray(jp.out_coords))
    assert int(tp.out_nnz) == int(jp.out_nnz)
    assert tp.mirror == jp.mirror
    if kind == "strided":
        np.testing.assert_array_equal(tp.inv_idx.numpy(),
                                      np.asarray(jp.inv_idx))
    assert (tp.in_idx >= 0).sum() > tp.in_idx.shape[1] // 2


def test_invert_plan_matches_jax_and_inverts():
    js, ts, _ = _plan_case("submanifold", False)
    w = np.zeros((27, 8, 8), np.float32)
    jconv.conv3d(js, jnp.asarray(w), 3)
    tconv.conv3d(ts, torch.from_numpy(w), 3)
    key = ("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))
    want = np.asarray(jconv.invert_plan(js.kmaps[key]))
    plan = ts.kmaps[key]
    inv = tconv.invert_plan(plan).numpy()
    np.testing.assert_array_equal(inv, want)
    in_idx = plan.in_idx.numpy()
    k, j = np.nonzero(in_idx >= 0)
    np.testing.assert_array_equal(inv[k, in_idx[k, j]], j)
    # submanifold: the inverse map is the mirrored forward map
    np.testing.assert_array_equal(inv, in_idx[np.asarray(plan.mirror)])


def _conv_pair(kind):
    rng = np.random.default_rng({"subm": 1, "strided": 2, "transposed": 3,
                                 "1x1": 4}[kind])
    coords = _sorted_cloud(rng, 600, span=10)
    ci, co = 6, 5
    feats = rng.standard_normal((len(coords), ci)).astype(np.float32)
    js, ts, n = _pair(coords, feats, len(coords) + 20)
    return rng, js, ts, n, ci, co


@pytest.mark.parametrize("kind", ["subm", "strided", "transposed", "1x1"])
def test_conv3d_matches_jax(kind):
    rng, js, ts, n, ci, co = _conv_pair(kind)

    def both(fn_j, fn_t, shape, **kw):
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        return fn_j(jnp.asarray(w), **kw), fn_t(torch.from_numpy(w), **kw)

    if kind == "subm":
        jo, to = both(lambda w, **kw: jconv.conv3d(js, w, 3, **kw),
                      lambda w, **kw: tconv.conv3d(ts, w, 3, **kw),
                      (27, ci, co))
    elif kind == "1x1":
        jo, to = both(lambda w: jconv.conv3d(js, w, 1),
                      lambda w: tconv.conv3d(ts, w, 1), (ci, co))
    else:
        jo, to = both(
            lambda w: jconv.conv3d(js, w, 2, stride=2, out_capacity=300),
            lambda w: tconv.conv3d(ts, w, 2, stride=2, out_capacity=300),
            (8, ci, co))
        if kind == "transposed":
            jo, to = both(
                lambda w: jconv.conv3d(jo, w, 2, stride=2, transposed=True),
                lambda w: tconv.conv3d(to, w, 2, stride=2, transposed=True),
                (8, co, 4))
    m = int(jo.nnz)
    assert int(to.nnz) == m and to.stride == jo.stride
    assert to.coords_sorted == jo.coords_sorted
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(jo.coords))
    assert _rel(to.feats.numpy()[:m], np.asarray(jo.feats)[:m]) < F32_TOL


def test_submanifold_conv_matches_dense_conv():
    """Ground truth independent of both packages' kernel maps: scatter the
    voxels into a dense grid and run lax.conv_general_dilated with the
    centered z-major taps laid out as a DHWIO kernel."""
    rng = np.random.default_rng(9)
    shape, nb, ci, co = (11, 9, 7), 2, 5, 3
    pts = np.stack([rng.integers(0, s, 350) for s in shape]
                   + [rng.integers(0, nb, 350)], 1).astype(np.int32)
    pts = np.unique(pts, axis=0)
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]))]
    feats = rng.standard_normal((len(pts), ci)).astype(np.float32)
    w = rng.standard_normal((27, ci, co)).astype(np.float32)

    _, ts, n = _pair(pts, feats, len(pts) + 13)
    got = tconv.conv3d(ts, torch.from_numpy(w), 3).feats.numpy()[:n]

    nx, ny, nz = shape
    grid = np.zeros((nb, nz, ny, nx, ci), np.float32)
    grid[pts[:, 3], pts[:, 2], pts[:, 1], pts[:, 0]] = feats
    kern = np.zeros((3, 3, 3, ci, co), np.float32)
    for k, (ox, oy, oz) in enumerate(tc.kernel_offsets_np(3)):
        kern[oz + 1, oy + 1, ox + 1] = w[k]
    dn = lax.conv_dimension_numbers(grid.shape, kern.shape,
                                    ("NDHWC", "DHWIO", "NDHWC"))
    dense = np.asarray(lax.conv_general_dilated(
        jnp.asarray(grid), jnp.asarray(kern), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=dn, precision=lax.Precision.HIGHEST))
    want = dense[pts[:, 3], pts[:, 2], pts[:, 1], pts[:, 0]]
    assert _rel(got, want) < F32_TOL
