"""The ELK block's aggregation (`ops/elk.elk_aggregate` over
`elk_aux_plan`) on the CPU, through the plain twin of the
`elk_aggregate` kernel:

- forward and gradient against the reference composition of the same
  module (voxel_to_aux + aux_to_voxel through spvoxelize / spdevoxelize,
  differentiated by autograd; the forward in the same dtype, the gradient
  in float32), for r = 2 and 3, float32 and bfloat16, on a
  cloud with padding rows, with an isolated aux cell (a window that holds
  no other cell) and with more aux cells than the capacity;
- forward and gradient against `link_tpu`'s voxel_to_aux + aux_to_voxel;
- the plan: the inverse taps cover every valid (tap, row) pair once, the
  CSR groups each cell's voxels (its counts are spcount's), and inference
  builds no inverse;
- a rematerialized ELK block's replay runs the aggregation with the
  forward's plan and gives its value to the bit;
- the wrapper takes the twin for CPU tensors only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from link_tpu.ops import elk as jelk
from link_tpu.sparse import coords as jc
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.models.elk import ELKBlock
from link_tpu_torch.nn import remat
from link_tpu_torch.ops import elk as telk
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import ops as tops
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the forward rounds where the reference composition rounds, and sums in
# its order: float32 and bfloat16 outputs alike agree to float32 noise
F32_TOL = 1e-5
# the gradient rounds a float32 sum to bfloat16 once (half an ulp, 2^-9),
# against autograd through the composition in float32 on the same values
BF16_TOL = 8e-3
S = 3
CASES = ["padded", "isolated", "overflow"]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _cloud(case, seed, pad=29):
    """Clustered unique coords of 2 batches in pack-key order, then `pad`
    sentinel rows; "isolated" adds a voxel whose aux cell has no other cell
    in reach. Returns (coords, live rows, aux capacity)."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-1, 2, (600, 3)), 0) % 20
    b = np.sort(rng.integers(0, 2, 600))
    pts = np.concatenate([walk, b[:, None]], 1).astype(np.int32)
    if case == "isolated":
        pts = np.concatenate([pts, np.array([[60, 60, 60, 0]], np.int32)])
    pts = np.unique(pts, axis=0)
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]))]
    cells = len(np.unique(np.concatenate([pts[:, :3] // S, pts[:, 3:]], 1),
                          axis=0))
    cap = cells - 20 if case == "overflow" else len(pts)
    coords = np.concatenate(
        [pts, np.full((pad, 4), jc.INVALID_COORD, np.int32)])
    return coords, len(pts), cap


def _inputs(case, seed, c=9):
    coords, n, cap = _cloud(case, seed)
    rng = np.random.default_rng(seed + 100)
    feats = rng.standard_normal((len(coords), c)).astype(np.float32)
    cot = rng.standard_normal((len(coords), c)).astype(np.float32)
    return coords, n, cap, feats, cot


def _run(fn, coords, n, feats, cot, dtype):
    """fn(st) -> (N, C) feats, and the gradient of <out, cot> in feats."""
    f = torch.from_numpy(feats).to(dtype).requires_grad_()
    st = t_make(f, coords, nnz=n, base_sorted=True, device="cpu")
    out = fn(st)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    return out.detach().float().numpy(), f.grad.float().numpy()


def _new(r, cap):
    def fn(st):
        plan = telk.elk_aux_plan(st, S, r, cap, inverse=True)
        return telk.elk_aggregate(st.feats, plan)
    return fn


def _reference(r, cap):
    def fn(st):
        aux, idx, counts = telk.voxel_to_aux(st, S, cap)
        return telk.aux_to_voxel(aux, st, idx, counts, r).feats
    return fn


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 3])
def test_elk_aggregate_matches_the_reference_composition(r, dtype, case):
    coords, n, cap, feats, cot = _inputs(case, 7 * r)
    dt = getattr(torch, dtype)
    # the same values in both dtypes
    feats = torch.from_numpy(feats).to(dt).float().numpy()
    cot = torch.from_numpy(cot).to(dt).float().numpy()
    got, grad = _run(_new(r, cap), coords, n, feats, cot, dt)
    want, _ = _run(_reference(r, cap), coords, n, feats, cot, dt)
    _, want_grad = _run(_reference(r, cap), coords, n, feats, cot,
                        torch.float32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got, want) < F32_TOL and _rel(grad, want_grad) < tol
    # padding rows get zero and pass no gradient
    assert not got[n:].any() and not grad[n:].any()
    if case == "overflow":
        assert (~want.any(1)[:n]).sum() > 0
        np.testing.assert_array_equal(got[:n].any(1), want[:n].any(1))
    if case == "isolated":
        # the lone voxel's window holds its own cell only: its mean
        row = int(np.nonzero((coords[:n, :3] == 60).all(1))[0][0])
        np.testing.assert_allclose(got[row], feats[row], rtol=tol, atol=tol)


@pytest.mark.parametrize("r", [2, 3])
def test_elk_aggregate_matches_jax(r):
    coords, n, cap, feats, cot = _inputs("padded", 11 * r)
    got, grad = _run(_new(r, cap), coords, n, feats, cot, torch.float32)

    def agg(f):
        js = j_make(f, jnp.asarray(coords), nnz=n, base_sorted=True)
        aux, idx, counts = jelk.voxel_to_aux(js, S, cap)
        return jelk.aux_to_voxel(aux, js, idx, counts, r).feats

    want, vjp = jax.vjp(agg, jnp.asarray(feats))
    want_grad, = vjp(jnp.asarray(cot))
    assert _rel(got[:n], np.asarray(want)[:n]) < F32_TOL
    assert _rel(grad[:n], np.asarray(want_grad)[:n]) < F32_TOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("r", [2, 3])
def test_elk_plan_inverse_taps_and_cells(r, case):
    coords, n, cap, feats, _ = _inputs(case, 5 * r)
    st = t_make(feats, coords, nnz=n, base_sorted=True, device="cpu")
    plan = telk.elk_aux_plan(st, S, r, cap, inverse=True)
    taps, inv = plan.taps.numpy(), plan.inv.numpy()
    k, m = taps.shape
    assert k == r ** 3 and m == cap and inv.shape == (k, m)
    # every valid (tap, row) pair once, in both directions
    for t in range(k):
        rows = np.nonzero(taps[t] >= 0)[0]
        np.testing.assert_array_equal(inv[t, taps[t, rows]], rows)
        hits = np.nonzero(inv[t] >= 0)[0]
        np.testing.assert_array_equal(taps[t, inv[t, hits]], hits)
        assert len(rows) == len(hits)
    # the CSR: each cell's voxels in row order, its count spcount's, the
    # rows of no cell last
    _, idx, counts = telk.voxel_to_aux(st, S, cap)
    order, start = plan.order.numpy(), plan.start.numpy()
    np.testing.assert_array_equal(np.diff(start), counts.numpy())
    assert int(plan.nnz) == int((counts > 0).sum())
    idx = idx.numpy()
    for j in range(m):
        cell = order[start[j]:start[j + 1]]
        assert (idx[cell] == j).all() and (np.diff(cell) > 0).all()
    assert (idx[order[start[m]:]] == -1).all()
    assert sorted(order) == list(range(len(coords)))
    # inference needs no inverse
    assert telk.elk_aux_plan(st, S, r, cap, inverse=False).inv is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elk_block_replay_reads_the_plan_and_equals_the_forward(
        dtype, monkeypatch):
    coords, n, cap, feats, cot = _inputs("padded", 3, c=8)
    dt = getattr(torch, dtype)
    calls = []
    real = kernels.elk_aggregate

    def spy(x, order, start, nnz, taps, denom=None):
        out = real(x, order, start, nnz, taps, denom)
        calls.append((denom is None, remat.replaying(), out[0],
                      taps.data_ptr()))
        return out
    monkeypatch.setattr(kernels, "elk_aggregate", spy)
    grads, outs = {}, {}
    for rematerialized in (False, True):
        block = ELKBlock(8, aux_capacity=cap, device="cpu",
                         generator=torch.Generator().manual_seed(0)).to(dt)
        if rematerialized:
            block.remat_policy = remat.PLANS_AND_CONV_OUTPUTS
        f = torch.from_numpy(feats).to(dt).requires_grad_()
        st = t_make(f, coords, nnz=n, base_sorted=True, device="cpu")
        calls.clear()
        out = block(st, S, 2).feats
        out.backward(torch.from_numpy(cot).to(dt))
        grads[rematerialized], outs[rematerialized] = f.grad, out.detach()
        fwd = [c for c in calls if c[0]]
        if rematerialized:
            # the forward, then its replay over the same (taped) plan
            assert [c[1] for c in fwd] == [False, True]
            assert torch.equal(fwd[0][2], fwd[1][2])
            assert fwd[0][3] == fwd[1][3]
        else:
            assert [c[1] for c in fwd] == [False]
        assert [c[0] for c in calls].count(False) == 1      # one backward
    assert torch.equal(outs[True], outs[False])
    assert torch.equal(grads[True], grads[False])


def test_elk_aggregate_takes_the_twin_on_the_cpu_only():
    coords, n, cap, feats, _ = _inputs("padded", 1)
    st = t_make(feats, coords, nnz=n, base_sorted=True, device="cpu")
    plan = telk.elk_aux_plan(st, S, 2, cap, inverse=True)
    x = torch.from_numpy(feats)
    args = (plan.order, plan.start, plan.nnz, plan.taps)
    out, denom = kernels.elk_aggregate(x, *args)
    want, want_d = kernels.elk_aggregate_plain(x, *args)
    assert torch.equal(out, want) and torch.equal(denom, want_d)
    assert kernels.elk_aggregate.launches == 0
    meta = [t.to("meta") for t in (x,) + args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.elk_aggregate(*meta)
    # the window counts are the reference's count channel
    aux, idx, counts = telk.voxel_to_aux(st, S, cap)
    nb = plan.taps.numpy()
    cnt = counts.numpy()
    live = int(plan.nnz)
    want_count = np.where(nb >= 0, cnt[np.maximum(nb, 0)], 0).sum(0)
    np.testing.assert_array_equal(denom.numpy()[:live],
                                  np.maximum(want_count, 1)[:live])
    assert tops.spcount(idx, cap).equal(counts)
