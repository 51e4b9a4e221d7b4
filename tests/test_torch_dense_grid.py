"""Port vs JAX: the dense-grid ops of `sparse/dense_grid.py`.

The same random sparse rows (numpy, seeded) go through
`link_tpu.sparse.dense_grid` (eager JAX) and
`link_tpu_torch.sparse.dense_grid`. Bounds:
  * the scatter (`to_dense_grid`), `dense_to_bev`, `cell_coords_xyz`,
    `block_broadcast` and every mask: exact;
  * `block_pool` and `box_sum` (float32 sums in another order): 1e-6
    relative to the largest magnitude;
  * the float32 convs (`dense_subm_conv`, `dense_spconv`): 1e-5 relative
    to the largest magnitude, and the strided one also against the port's
    sparse `spconv3d` on the same rows (masks equal, feats within 1e-5,
    the bound of tests/test_dense_backbone.py);
  * the bfloat16 convs: 8e-3 relative (the port rounds the conv to
    bfloat16 before adding the float32 bias, JAX after).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.sparse import dense_grid as J
from link_tpu_torch.sparse import coords as tcoords
from link_tpu_torch.sparse import dense_grid as T
from link_tpu_torch.sparse import spconv_engine as teng
from link_tpu_torch.sparse.tensor import make_sparse_tensor

from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (12, 10, 7)          # (X, Y, Z)
BATCH = 2
CAP = 512
F32_TOL = 1e-5
BF16_TOL = 8e-3


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _rows(seed, n=300, ci=6, shape=SHAPE):
    """n distinct (x, y, z, b) rows in pack-key order, padded to CAP."""
    rng = np.random.default_rng(seed)
    pts = np.unique(np.stack(
        [rng.integers(0, shape[0], 3 * n), rng.integers(0, shape[1], 3 * n),
         rng.integers(0, shape[2], 3 * n), rng.integers(0, BATCH, 3 * n)],
        1).astype(np.int32), axis=0)[:n]
    key = ((pts[:, 3].astype(np.int64) * shape[2] + pts[:, 2]) * shape[1]
           + pts[:, 1]) * shape[0] + pts[:, 0]
    pts = pts[np.argsort(key)]
    coords = np.full((CAP, 4), tcoords.INVALID_COORD, np.int32)
    coords[:len(pts)] = pts
    feats = np.zeros((CAP, ci), np.float32)
    feats[:len(pts)] = rng.standard_normal((len(pts), ci))
    return feats, coords, len(pts)


def _grids(seed, ci=6, shape=SHAPE, dtype=torch.float32):
    feats, coords, n = _rows(seed, ci=ci, shape=shape)
    st = make_sparse_tensor(torch.from_numpy(feats).to(dtype), coords, nnz=n,
                            base_sorted=True, device="cpu")
    tg = T.to_dense_grid(st, shape, BATCH)
    jg = J.DenseGrid(feats=jnp.asarray(tg.feats.float().numpy(),
                                       jnp.bfloat16 if dtype == torch.bfloat16
                                       else jnp.float32),
                     mask=jnp.asarray(tg.mask.numpy()))
    return st, tg, jg


def test_to_dense_grid_and_bev_match_jax():
    from link_tpu.sparse.tensor import SparseTensor as JST
    feats, coords, n = _rows(0)
    st = make_sparse_tensor(torch.from_numpy(feats), coords, nnz=n,
                            base_sorted=True, device="cpu")
    tg = T.to_dense_grid(st, SHAPE, BATCH)
    jg = J.to_dense_grid(JST(feats=jnp.asarray(feats),
                             coords=jnp.asarray(coords), nnz=jnp.int32(n)),
                         SHAPE, BATCH)
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(tg.feats.numpy(), np.asarray(jg.feats))
    assert int(tg.mask.sum()) == n
    assert tg.feats.shape == (BATCH,) + SHAPE[::-1] + (6,)
    np.testing.assert_array_equal(T.dense_to_bev(tg).numpy(),
                                  np.asarray(J.dense_to_bev(jg)))
    # the BEV's channel order is to_dense_bev's
    np.testing.assert_array_equal(T.dense_to_bev(tg).numpy(),
                                  teng.to_dense_bev(st, SHAPE, BATCH).numpy())


@pytest.mark.parametrize("ks,bias", [(3, True), ((3, 3, 1), False),
                                     (2, True), ((1, 3, 5), True),
                                     (1, True)])
def test_dense_subm_conv_matches_jax(ks, bias):
    _, tg, jg = _grids(1)
    rng = np.random.default_rng(2)
    k = int(np.prod(tcoords.make_ntuple(ks)))
    shape = (k, 6, 8) if k > 1 else (6, 8)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if bias else None
    got = T.dense_subm_conv(tg, torch.from_numpy(w), ks,
                            None if b is None else torch.from_numpy(b))
    want = J.dense_subm_conv(jg, jnp.asarray(w), ks,
                             None if b is None else jnp.asarray(b))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert _rel(got.feats.numpy(), want.feats) < F32_TOL
    # the invariant: zero wherever the mask is off
    assert not got.feats[~got.mask].any()


@pytest.mark.parametrize("ks,st,pad", [(3, 2, 1), (3, 2, (1, 1, 0)),
                                       ((1, 1, 3), (1, 1, 2), 0),
                                       (2, 2, 0)])
def test_dense_spconv_matches_jax_and_the_sparse_conv(ks, st, pad):
    sp, tg, jg = _grids(3)
    rng = np.random.default_rng(4)
    k = int(np.prod(tcoords.make_ntuple(ks)))
    w = (rng.standard_normal((k, 6, 8)) * 0.2).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    got = T.dense_spconv(tg, torch.from_numpy(w), ks, st, pad,
                         torch.from_numpy(b))
    want = J.dense_spconv(jg, jnp.asarray(w), ks, st, pad, jnp.asarray(b))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert _rel(got.feats.numpy(), want.feats) < F32_TOL
    assert not got.feats[~got.mask].any()
    # the port's sparse strided conv on the same rows, scattered
    kk, ss, pp = (tcoords.make_ntuple(v) for v in (ks, st, pad))
    out, out_shape = teng.spconv3d(sp, torch.from_numpy(w), kk, SHAPE,
                                   stride=ss, padding=pp, out_capacity=CAP,
                                   batch_size=BATCH)
    ref = T.to_dense_grid(out, out_shape, BATCH)
    nob = T.dense_spconv(tg, torch.from_numpy(w), ks, st, pad)
    np.testing.assert_array_equal(nob.mask.numpy(), ref.mask.numpy())
    assert _rel(nob.feats.numpy(), ref.feats.numpy()) < F32_TOL


@pytest.mark.parametrize("op", ["subm", "spconv"])
def test_dense_convs_in_bfloat16_match_jax(op):
    _, tg, jg = _grids(5, dtype=torch.bfloat16)
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((27, 6, 8)) * 0.2).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    if op == "subm":
        got = T.dense_subm_conv(tg, torch.from_numpy(w), 3,
                                torch.from_numpy(b))
        want = J.dense_subm_conv(jg, jnp.asarray(w), 3, jnp.asarray(b))
    else:
        got = T.dense_spconv(tg, torch.from_numpy(w), 3, 2, 1,
                             torch.from_numpy(b))
        want = J.dense_spconv(jg, jnp.asarray(w), 3, 2, 1, jnp.asarray(b))
    assert got.feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert _rel(got.feats.float().numpy(),
                np.asarray(want.feats, np.float32)) < BF16_TOL


def test_masked_and_cell_coords_match_jax():
    _, tg, jg = _grids(7)
    x = torch.randn(tg.feats.shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tg.masked(x).feats.numpy(),
                                  np.asarray(jg.masked(jnp.asarray(
                                      x.numpy())).feats))
    np.testing.assert_array_equal(T.cell_coords_xyz(tg).numpy(),
                                  np.asarray(J.cell_coords_xyz(jg)))


@pytest.mark.parametrize("s,r", [(3, 3), (7, 1), (4, 5)])
def test_block_ops_match_jax(s, r):
    _, tg, jg = _grids(8)
    sums, counts = T.block_pool(tg.feats, tg.mask, s)
    jsums, jcounts = J.block_pool(jg.feats, jg.mask, s)
    assert _rel(sums.numpy(), jsums) < 1e-6
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert _rel(T.box_sum(sums, r).numpy(), J.box_sum(jsums, r)) < 1e-6
    spatial = tuple(tg.feats.shape[1:4])
    np.testing.assert_array_equal(
        T.block_broadcast(sums, s, spatial).numpy(),
        np.asarray(J.block_broadcast(jnp.asarray(sums.numpy()), s, spatial)))
