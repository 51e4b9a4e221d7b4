"""The port's point <-> voxel transforms (`link_tpu_torch/ops/point.py`) and
`upsample_voxel` against the JAX package's, eagerly, on seeded numpy
inputs.

Inputs hold padding rows (points past nnz, sentinel voxel rows), points
whose floor corners miss the voxel table, and fine rows that fall out of
key order once divided by the coarse stride. Indices and coords must be
equal; weights lie within 1e-6 (float32 sums of 8 terms in another order);
pooled and interpolated features within 1e-5 (sums of up to a few dozen
float32 terms of magnitude ~1 in another order); gathered features equal.
"""

import numpy as np
import pytest
import torch

from link_tpu.ops import elk as jelk
from link_tpu.ops import point as jpoint
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.ops import elk as telk
from link_tpu_torch.ops import kernels
from link_tpu_torch.ops import point as tpoint
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NP, NNZ = 300, 260         # point rows, valid points
W_TOL = 1e-6
F_TOL = 1e-5


def _points(seed):
    """(NP, 4) float32 positions in [0, 24)^3 with batch 0 or 1 (rows past
    NNZ are padding) and (NP, 6) feats."""
    rng = np.random.default_rng(seed)
    c = np.zeros((NP, 4), np.float32)
    c[:, :3] = rng.uniform(0, 24, (NP, 3))
    c[:, 3] = rng.integers(0, 2, NP)
    return c, rng.standard_normal((NP, 6)).astype(np.float32)


def _pts(c, f):
    return (jpoint.make_point_tensor(f, c, nnz=NNZ),
            tpoint.make_point_tensor(torch.from_numpy(f), torch.from_numpy(c),
                                     nnz=NNZ))


def _key_sorted_padded(rows, cap):
    """Rows in key order (b, z, y, x), padded with sentinel rows to cap."""
    rows = rows[np.lexsort((rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]))]
    out = np.full((cap, 4), C.INVALID_COORD, np.int32)
    out[:len(rows)] = rows
    return out


def _level(c, s, seed, cap=512, drop=0.2, ch=5):
    """The voxels of the valid points at stride s, in key order, a share
    `drop` of them left out (so some points miss), padded to `cap` rows;
    random feats. Returns (coords, feats, nnz)."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([np.floor(c[:NNZ, :3] / s).astype(np.int32) * s,
                        c[:NNZ, 3:].astype(np.int32)], 1)
    v = np.unique(v, axis=0)
    v = v[rng.random(len(v)) >= drop]
    return (_key_sorted_padded(v, cap),
            rng.standard_normal((cap, ch)).astype(np.float32), len(v))


def _both(coords, feats, nnz, s):
    return (j_make(feats, coords, nnz=nnz, stride=s, base_sorted=True),
            t_make(feats, coords, nnz=nnz, stride=s, base_sorted=True,
                   device="cpu"))


@pytest.mark.parametrize("res", [(1.0, 1.0), (0.05, 0.1)])
@pytest.mark.parametrize("cap", [512, 128])
def test_initial_voxelize_matches_jax(res, cap):
    c, f = _points(0)
    jp, tp = _pts(c, f)
    jst, jidx = jpoint.initial_voxelize(jp, res[0], res[1], cap)
    tst, tidx = tpoint.initial_voxelize(tp, res[0], res[1], cap)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tst.coords.numpy(), np.asarray(jst.coords))
    assert int(tst.nnz) == int(jst.nnz) and (cap < NNZ) == (int(tst.nnz) == cap)
    np.testing.assert_allclose(tst.feats.numpy(), np.asarray(jst.feats),
                               atol=F_TOL, rtol=0)
    for key in (("idx", (1, 1, 1)), ("counts", (1, 1, 1))):
        np.testing.assert_array_equal(tp.caches[key].numpy(),
                                      np.asarray(jp.caches[key]))
    assert tst.coords_sorted and tst.cmaps[(1, 1, 1)][0] is tst.coords


@pytest.mark.parametrize("s", [2, 4])
def test_point_to_voxel_matches_jax(s):
    c, f = _points(1)
    coords, feats, nnz = _level(c, s, seed=s)
    jst, tst = _both(coords, feats, nnz, s)
    jp, tp = _pts(c, f)
    jout, tout = jpoint.point_to_voxel(jst, jp), tpoint.point_to_voxel(tst, tp)
    idx = tp.caches[("idx", (s, s, s))].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jp.caches[("idx", (s,) * 3)]))
    assert (idx[:NNZ] < 0).any() and (idx[NNZ:] == -1).all()
    np.testing.assert_array_equal(tp.caches[("counts", (s,) * 3)].numpy(),
                                  np.asarray(jp.caches[("counts", (s,) * 3)]))
    np.testing.assert_allclose(tout.feats.numpy(), np.asarray(jout.feats),
                               atol=F_TOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_calc_ti_weights_matches_jax(scale):
    rng = np.random.default_rng(2)
    pc = rng.uniform(0, 40, (200, 3)).astype(np.float32)
    idx = rng.integers(-1, 50, (200, 8)).astype(np.int32)
    idx[:5] = -1                                   # every corner missing
    want = np.asarray(jpoint.calc_ti_weights(pc, idx, scale))
    got = tpoint.calc_ti_weights(torch.from_numpy(pc), torch.from_numpy(idx),
                                 scale).numpy()
    np.testing.assert_allclose(got, want, atol=W_TOL, rtol=0)
    assert (got[:5] == 0).all() and (got[idx < 0] == 0).all()


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_voxel_to_point_matches_jax(s, nearest):
    c, f = _points(3)
    coords, feats, nnz = _level(c, s, seed=10 + s)
    jst, tst = _both(coords, feats, nnz, s)
    jp, tp = _pts(c, f)
    jout = jpoint.voxel_to_point(jst, jp, nearest=nearest)
    tout = tpoint.voxel_to_point(tst, tp, nearest=nearest)
    key_i, key_w = ("v2p_idx", (s,) * 3), ("v2p_w", (s,) * 3)
    idx = tp.caches[key_i].numpy()
    assert idx.shape == (NP, 8)
    np.testing.assert_array_equal(idx, np.asarray(jp.caches[key_i]))
    hit = idx[:NNZ] >= 0
    assert hit.any() and (~hit).any() and (idx[NNZ:] == -1).all()
    np.testing.assert_allclose(tp.caches[key_w].numpy(),
                               np.asarray(jp.caches[key_w]), atol=W_TOL,
                               rtol=0)
    np.testing.assert_allclose(tout.feats.numpy(), np.asarray(jout.feats),
                               atol=F_TOL, rtol=0)


def _pack(rows):
    hi, lo = kernels.pack_coords(torch.from_numpy(rows))
    return kernels.key64(hi, lo).numpy()


def test_upsample_voxel_matches_jax():
    rng = np.random.default_rng(4)
    s = 4
    fine = np.unique(np.concatenate([rng.integers(0, 30, (400, 3)),
                                     rng.integers(0, 2, (400, 1))], 1)
                     .astype(np.int32), axis=0)
    n_f = len(fine)
    fc = _key_sorted_padded(fine, 512)
    # the coarse level: the fine rows' ancestors at stride 4, a fifth of
    # them left out, so some fine rows find none
    anc = fine.copy()
    anc[:, :3] = anc[:, :3] // s * s
    anc = np.unique(anc, axis=0)
    anc = anc[rng.random(len(anc)) >= 0.2]
    cc = _key_sorted_padded(anc, 256)
    cfeats = rng.standard_normal((256, 5)).astype(np.float32)
    div = fc[:n_f].copy()
    div[:, :3] //= s
    assert (np.diff(_pack(div)) < 0).any(), "divided rows stay in key order"
    j_fine, t_fine = _both(fc, np.zeros((512, 2), np.float32), n_f, 1)
    j_coarse, t_coarse = _both(cc, cfeats, len(anc), s)
    want = np.asarray(jelk.upsample_voxel(j_coarse, j_fine).feats)
    got = telk.upsample_voxel(t_coarse, t_fine)
    np.testing.assert_array_equal(got.feats.numpy(), want)
    assert got.coords is t_fine.coords and got.stride == (1, 1, 1)
    zero = (want[:n_f] == 0).all(1)
    assert zero.any() and (~zero).any() and (want[n_f:] == 0).all()


def test_each_transform_is_one_join_and_reuses_its_cache(monkeypatch):
    calls = []
    real = kernels.sorted_join

    def counting(*args, **kw):
        calls.append(args[3].shape)
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "sorted_join", counting)
    c, f = _points(6)
    coords, feats, nnz = _level(c, 2, seed=7)
    _, tst = _both(coords, feats, nnz, 2)
    _, tp = _pts(c, f)
    tpoint.voxel_to_point(tst, tp)
    tpoint.voxel_to_point(tst, tp.replace(feats=tp.feats * 2))
    tpoint.point_to_voxel(tst, tp)
    tpoint.point_to_voxel(tst, tp)
    assert calls == [(NP, 4), (NP, 4)]


def test_new_sites_form_their_inputs_in_the_input_range():
    """Each uncached point join and each upsample_voxel forms its inputs
    (the floored base rows; both divided coord sets) inside one
    JOIN_INPUT_RANGE before its JOIN_RANGE, and a cached join enters
    neither range."""
    c, f = _points(8)
    coords, feats, nnz = _level(c, 2, seed=9)
    _, tst = _both(coords, feats, nnz, 2)
    _, tp = _pts(c, f)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        tpoint.voxel_to_point(tst, tp)
        tpoint.voxel_to_point(tst, tp)               # cached
        tpoint.point_to_voxel(tst, tp)
        telk.upsample_voxel(tst, tst)
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    spans = [(e.name, e.time_range) for e in events
             if e.name in (C.JOIN_INPUT_RANGE, C.JOIN_RANGE)]
    assert [n for n, _ in spans] == [C.JOIN_INPUT_RANGE, C.JOIN_RANGE] * 3
    forming = [e.time_range for e in events
               if e.name in ("aten::floor", "aten::div")]

    def holds(r):
        return any(r.start <= t.start and t.end <= r.end for t in forming)

    assert all(holds(r) == (n == C.JOIN_INPUT_RANGE) for n, r in spans)
