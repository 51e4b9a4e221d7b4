"""Port vs JAX: pooling ops, the ELK aux transforms and the ELK block.

Inputs come from numpy seeds and go through both packages. Integer outputs
are compared exactly; float32 outputs as max|port - ref| / max|ref| < 1e-5
(same arithmetic, other summation order); the ELK block as a whole to
< 5e-5 (see ELK_TOL). The reference golden of the ELK block is held to
< 2e-4, the bound of the JAX package's own golden test.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.models.elk import ELKBlock as JELKBlock
from link_tpu.ops import elk as jelk
from link_tpu.sparse import coords as jc
from link_tpu.sparse import ops as jops
from link_tpu.sparse.dense_grid import box_sum as j_box_sum
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.models.elk import ELKBlock as TELKBlock
from link_tpu_torch.ops import elk as telk
from link_tpu_torch.sparse import ops as tops
from link_tpu_torch.sparse.dense_grid import box_sum as t_box_sum
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
# the ELK block adds sin/cos of the positional map (libm and XLA differ in
# the last ulps) ahead of two LayerNorms, which divide by the row's spread
ELK_TOL = 5e-5
GOLDEN_TOL = 2e-4
TSELK = os.path.join(os.path.dirname(__file__), "goldens", "tselk_cos.npz")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n, span, nb=2, pad=0):
    """Clustered unique coords in pack-key order, then `pad` sentinel rows."""
    walk = np.cumsum(rng.integers(-1, 2, (n, 3)), 0) % span
    b = np.sort(rng.integers(0, nb, n))
    pts = np.unique(np.concatenate([walk, b[:, None]], 1).astype(np.int32),
                    axis=0)
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]))]
    return np.concatenate([pts, np.full((pad, 4), jc.INVALID_COORD, np.int32)])


def test_spcount_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 50, 400).astype(np.int32)
    np.testing.assert_array_equal(tops.spcount(_t(idx), 50).numpy(),
                                  np.asarray(jops.spcount(jnp.asarray(idx), 50)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spvoxelize_matches_jax(dtype):
    rng = np.random.default_rng(1)
    idx = rng.integers(-1, 40, 500).astype(np.int32)
    feats = rng.standard_normal((500, 7)).astype(np.float32)
    counts = np.asarray(jops.spcount(jnp.asarray(idx), 40))
    want = jops.spvoxelize(jnp.asarray(feats, dtype), jnp.asarray(idx),
                           jnp.asarray(counts))
    got = tops.spvoxelize(_t(feats).to(getattr(torch, dtype)), _t(idx),
                          _t(counts))
    assert got.dtype == getattr(torch, dtype)
    # f32 sums of the same values in another order; bf16 rounds those once
    tol = F32_TOL if dtype == "float32" else 8e-3
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < tol


def test_spdevoxelize_matches_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((60, 13)).astype(np.float32)
    idx = rng.integers(-1, 60, (90, 8)).astype(np.int32)
    w = rng.random((90, 8)).astype(np.float32)
    want = jops.spdevoxelize(jnp.asarray(feats), jnp.asarray(idx),
                             jnp.asarray(w))
    got = tops.spdevoxelize(_t(feats), _t(idx), _t(w))
    assert _rel(got.numpy(), want) < F32_TOL


@pytest.mark.parametrize("case", ["plain", "overflow", "stride2_sentinel"])
def test_spdownsample_matches_jax(case):
    rng = np.random.default_rng(3)
    c = _cloud(rng, 500, span=16, pad=23)
    ts, cap = 1, 400
    if case == "overflow":
        cap = 40                      # fewer slots than coarse cells
    if case == "stride2_sentinel":
        c[:, :3] = np.where(c[:, :1] <= jc.INVALID_COORD, c[:, :3],
                            c[:, :3] * 2)
        ts = 2
    jo, jn = jops.spdownsample(jnp.asarray(c), cap, 2, 2, ts)
    to, tn = tops.spdownsample(_t(c), cap, 2, 2, ts)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tn) == int(jn)
    if case == "overflow":
        assert int(tn) == cap
    assert (to.numpy()[int(tn):] == jc.INVALID_COORD).all()


def test_box_sum_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5, 6, 7, 3)).astype(
        np.float32)
    for r in (1, 3, 5):
        assert _rel(t_box_sum(_t(x), r).numpy(),
                    j_box_sum(jnp.asarray(x), r)) < F32_TOL


def _pair(coords, feats, nnz, extent=None):
    js = j_make(feats, coords, nnz=nnz, base_sorted=True, grid_extent=extent)
    ts = t_make(feats, coords, nnz=nnz, base_sorted=True, grid_extent=extent,
                device="cpu")
    return js, ts


@pytest.mark.parametrize("r", [2, 3])
def test_voxel_to_aux_and_aux_to_voxel_match_jax(r):
    rng = np.random.default_rng(5 + r)
    c = _cloud(rng, 700, span=20, pad=31)
    n = len(c) - 31
    feats = rng.standard_normal((len(c), 9)).astype(np.float32)
    js, ts = _pair(c, feats, n)
    ja, jidx, jcnt = jelk.voxel_to_aux(js, 3, 600)
    ta, tidx, tcnt = telk.voxel_to_aux(ts, 3, 600)
    np.testing.assert_array_equal(ta.coords.numpy(), np.asarray(ja.coords))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert _rel(ta.feats.numpy(), ja.feats) < F32_TOL
    jv = jelk.aux_to_voxel(ja, js, jidx, jcnt, r).feats
    tv = telk.aux_to_voxel(ta, ts, tidx, tcnt, r).feats
    assert _rel(tv.numpy()[:n], np.asarray(jv)[:n]) < F32_TOL


@pytest.mark.parametrize("r,extent,want_dense", [
    (2, None, False), (2, (30, 30, 30, 2), False), (3, None, False),
    (3, (30, 30, 30, 2), True), (3, (4000, 4000, 500, 1), False)])
def test_dense_aux_gate_matches_jax(r, extent, want_dense):
    c = _cloud(np.random.default_rng(6), 50, span=30, pad=3)
    js, ts = _pair(c, np.zeros((len(c), 4), np.float32), len(c) - 3, extent)
    gj = jelk.use_dense_aux(js, 3, r, 33)
    gt = telk.use_dense_aux(ts, 3, r, 33)
    assert gt == gj and (gt is not None) == want_dense


def _elk_weights(rng, inc, cg, alpha):
    """Reference-keyed state for the port and the same values as the JAX
    block's param tree."""
    sd = {
        "pre_mix.0.weight": rng.standard_normal((inc, inc)) / np.sqrt(inc),
        "pre_mix.1.weight": 1 + 0.1 * rng.standard_normal(inc),
        "pre_mix.1.bias": 0.1 * rng.standard_normal(inc),
        "local_mix.0.kernel": rng.standard_normal((27, inc, inc)) / np.sqrt(27 * inc),
        "pos_weight.0.weight": 0.3 * rng.standard_normal((cg, 3)),
        "norm.weight": 1 + 0.1 * rng.standard_normal(inc),
        "norm.bias": 0.1 * rng.standard_normal(inc),
        "norm_local.weight": 1 + 0.1 * rng.standard_normal(inc),
        "norm_local.bias": 0.1 * rng.standard_normal(inc),
    }
    if alpha:
        sd["alpha"] = 1 + 0.2 * rng.standard_normal((1, cg))
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    return sd, _jax_elk_params(sd)


def _jax_elk_params(sd):
    params = {
        "pre_mix": {"kernel": sd["pre_mix.0.weight"].T},
        "pre_mix_norm": {"scale": sd["pre_mix.1.weight"],
                         "bias": sd["pre_mix.1.bias"]},
        "local_mix": {"kernel": sd["local_mix.0.kernel"]},
        "pos_weight": {"kernel": sd["pos_weight.0.weight"].T},
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
        "norm_local": {"scale": sd["norm_local.weight"],
                       "bias": sd["norm_local.bias"]},
    }
    if "alpha" in sd:
        params["alpha"] = sd["alpha"]
    return params


@pytest.mark.parametrize("path", ["sparse_r2", "dense_r3"])
@pytest.mark.parametrize("baseop", ["cos_x", "cos", "sin"])
def test_elk_block_matches_jax(baseop, path):
    rng = np.random.default_rng(
        ["cos_x", "cos", "sin"].index(baseop) * 2 + (path == "dense_r3"))
    inc, span, pad = 8, 18, 21
    c = _cloud(rng, 400, span=span, pad=pad)
    n = len(c) - pad
    feats = rng.standard_normal((len(c), inc)).astype(np.float32)
    r = 2 if path == "sparse_r2" else 3
    extent = None if path == "sparse_r2" else (span, span, span, 2)
    js, ts = _pair(c, feats, n, extent)
    assert (jelk.use_dense_aux(js, 3, r, 3 * inc) is not None) == (r == 3)

    sd, params = _elk_weights(rng, inc, inc, baseop == "cos_x")
    jblock = JELKBlock(inc=inc, aux_capacity=len(c), baseop=baseop)
    want = np.asarray(jblock.apply({"params": params}, js, 3, r, False).feats)
    tblock = TELKBlock(inc, aux_capacity=len(c), baseop=baseop, device="cpu")
    tblock.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    got = tblock(ts, 3, r).feats.detach().numpy()
    assert _rel(got[:n], want[:n]) < ELK_TOL


@pytest.mark.skipif(not os.path.exists(TSELK), reason="no det golden")
@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_tselk_golden(path):
    """Reference TSELKBlock golden (cos basis, det channel grouping, r=3)
    through both aux paths, as test_golden_parity.py holds the JAX block."""
    g = np.load(TSELK)
    coords, feats, want = g["coords"], g["feats"], g["out"]
    inc, block_sz = int(g["inc"]), int(g["block_sz"])
    sd = {k[3:].replace("__", "."): g[k] for k in g.files
          if k.startswith("sd_")}
    n, cap = len(coords), 1024
    cpad = np.full((cap, 4), jc.INVALID_COORD, np.int32)
    fpad = np.zeros((cap, inc), np.float32)
    cpad[:n], fpad[:n] = coords, feats
    ext = None
    if path == "dense":
        ext = tuple(int(v) for v in coords[:, :3].max(0) + 1) + (
            int(coords[:, 3].max()) + 1,)
    st = t_make(fpad, cpad, nnz=n, grid_extent=ext, device="cpu")
    assert (telk.use_dense_aux(st, block_sz, 3, 2 * inc) is not None) == (
        path == "dense")
    block = TELKBlock(inc, aux_capacity=cap, baseop="cos", det_grouping=True,
                      device="cpu")
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    got = block(st, block_sz, 3).feats.detach().numpy()[:n]
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < GOLDEN_TOL, f"tselk {path} rel err {err}"
