"""Gradients of the port's sparse conv and ELK window sum.

`GatherConv` (link_tpu_torch/sparse/conv.py) runs its kernels' plain twins
on the CPU. It is held against `jax.vjp` of `link_tpu.sparse.conv._gm` on
the same feats, weight, kernel map, inverse map and cotangent (all made with
numpy), for the four plan kinds of tests/test_conv_vjp.py and in float32 and
bfloat16, and against PyTorch autograd through `gather_conv_plain`.

Tolerances, relative to each tensor's largest magnitude:
  * float32: 1e-5. Both sides sum the same float32 products; only the
    order differs.
  * bfloat16 feature gradient: 8e-3. Both round one float32 sum to
    bfloat16; a different summation order can move a value across a
    rounding boundary, one ulp (2^-8).
  * bfloat16 weight gradient: 1e-5. It is a float32 sum of exact products
    of bfloat16 values on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.sparse import conv as jconv
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as tcoords
from link_tpu_torch.sparse import ops as tops
from link_tpu_torch.sparse.tensor import make_sparse_tensor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
BF16_TOL = 8e-3
CAP, C, CO = 512, 8, 12


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _random_sparse(rng, n, cap, c, span=24, sort=False):
    coords = np.unique(
        np.stack([rng.integers(0, span, 4 * n), rng.integers(0, span, 4 * n),
                  rng.integers(0, span, 4 * n), np.zeros(4 * n, np.int64)],
                 1).astype(np.int32), axis=0)
    coords = coords[rng.permutation(len(coords))[:n]]
    if sort:
        coords = coords[np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))]
    pc = np.full((cap, 4), tcoords.INVALID_COORD, np.int32)
    pc[:len(coords)] = coords
    pf = np.zeros((cap, c), np.float32)
    pf[:len(coords)] = rng.normal(size=(len(coords), c))
    return pf, pc, len(coords)


def _plan_case(mode):
    """(feats, weight, idx, bwd_idx, out_rows) of one plan kind, the maps
    built by the port: what `apply_conv_plan` hands to `GatherConv`."""
    rng = np.random.default_rng(3)
    pf, pc, nnz = _random_sparse(rng, 400, CAP, C, sort=mode == "subm_sorted")
    st = make_sparse_tensor(pf, pc, nnz=nnz, device="cpu",
                            base_sorted=mode == "subm_sorted")
    if mode in ("subm", "subm_sorted"):
        w = rng.normal(size=(27, C, CO)).astype(np.float32) * 0.2
        out = tconv.conv3d(st, torch.from_numpy(w), 3)
        plan = st.kmaps[("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))]
        assert plan.mirror is not None
        return pf, w, plan.in_idx, tconv.plan_bwd_idx(plan), out.capacity
    w = rng.normal(size=(8, C, CO)).astype(np.float32) * 0.2
    down = tconv.conv3d(st, torch.from_numpy(w), 2, stride=2,
                        out_capacity=CAP // 2)
    plan = st.kmaps[("plan", (1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1))]
    assert plan.mirror is None and plan.inv_idx is not None
    if mode == "strided":
        return pf, w, plan.in_idx, tconv.plan_bwd_idx(plan), down.capacity
    # transposed: feats live on the plan's output side
    f = np.zeros((CAP // 2, C), np.float32)
    f[:int(down.nnz)] = rng.normal(size=(int(down.nnz), C))
    return f, w, plan.inv_idx, plan.in_idx, CAP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["subm", "subm_sorted", "strided",
                                  "transposed"])
def test_gather_conv_function_matches_jax_vjp(mode, dtype):
    feats, w, idx, bwd_idx, m = _plan_case(mode)
    rng = np.random.default_rng(5)
    cot = rng.normal(size=(m, CO)).astype(np.float32)
    tdt = getattr(torch, dtype)

    out_j, vjp = jax.vjp(
        lambda f, ww: jconv._gm(f, ww, jnp.asarray(idx.numpy()),
                                jnp.asarray(bwd_idx.numpy())),
        jnp.asarray(feats, dtype), jnp.asarray(w))
    df_j, dw_j = vjp(jnp.asarray(cot, dtype))

    f_t = torch.from_numpy(feats).to(tdt).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out_t = tconv.GatherConv.apply(f_t, w_t, idx, bwd_idx)
    out_t.backward(torch.from_numpy(cot).to(tdt))

    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out_t.dtype == tdt and f_t.grad.dtype == tdt
    assert w_t.grad.dtype == torch.float32 and dw_j.dtype == jnp.float32
    assert _rel(out_t.detach().float().numpy(),
                np.asarray(out_j, np.float32)) < tol
    assert _rel(f_t.grad.float().numpy(), np.asarray(df_j, np.float32)) < tol
    assert _rel(w_t.grad.numpy(), np.asarray(dw_j)) < F32_TOL
    assert np.abs(np.asarray(dw_j)).max() > 0


@pytest.mark.parametrize("mode", ["subm", "subm_sorted", "strided",
                                  "transposed"])
def test_gather_conv_function_matches_autograd_of_plain(mode):
    feats, w, idx, bwd_idx, m = _plan_case(mode)
    cot = torch.from_numpy(
        np.random.default_rng(6).normal(size=(m, CO)).astype(np.float32))
    grads = []
    for fn in (lambda f, ww: tconv.GatherConv.apply(f, ww, idx, bwd_idx),
               lambda f, ww: kernels.gather_conv_plain(f, idx, ww)):
        f_t = torch.from_numpy(feats).requires_grad_()
        w_t = torch.from_numpy(w).requires_grad_()
        fn(f_t, w_t).backward(cot)
        grads.append((f_t.grad, w_t.grad))
    assert _rel(grads[0][0], grads[1][0]) < F32_TOL
    assert _rel(grads[0][1], grads[1][1]) < F32_TOL


def test_conv3d_chain_takes_the_function_and_matches_plain_autograd():
    """down conv -> transposed conv through `conv3d`: the plans choose the
    inverse maps (`inv_idx` down, `in_idx` up), and the stem-like input
    without a gradient skips d_feats."""
    rng = np.random.default_rng(9)
    pf, pc, nnz = _random_sparse(rng, 400, CAP, C)
    w1 = torch.from_numpy(rng.normal(size=(8, C, C)).astype(np.float32) * .2)
    w2 = torch.from_numpy(rng.normal(size=(8, C, CO)).astype(np.float32) * .2)

    def run(direct):
        a, b = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        st = make_sparse_tensor(pf, pc, nnz=nnz, device="cpu")
        if direct:
            down = tconv.conv3d(st, a, 2, stride=2, out_capacity=CAP // 2)
            up = tconv.conv3d(down, b, 2, stride=2, transposed=True).feats
        else:
            with torch.no_grad():
                tconv.conv3d(st, a, 2, stride=2, out_capacity=CAP // 2)
            plan = st.kmaps[("plan", (1, 1, 1), (2, 2, 2), (2, 2, 2),
                             (1, 1, 1))]
            down = kernels.gather_conv_plain(st.feats, plan.in_idx, a)
            up = kernels.gather_conv_plain(down, plan.inv_idx, b)
        valid = (torch.arange(CAP) < nnz)[:, None]
        torch.where(valid, up, 0.0).square().sum().backward()
        return a.grad, b.grad

    before = kernels.gather_conv.launches, kernels.gather_wgrad.launches
    got, want = run(True), run(False)
    # the twins ran: a CPU tensor launches nothing
    assert (kernels.gather_conv.launches,
            kernels.gather_wgrad.launches) == before
    for g, w_ in zip(got, want):
        assert _rel(g, w_) < F32_TOL and float(w_.abs().max()) > 0


def test_plan_bwd_idx_is_the_inverse_and_is_cached():
    rng = np.random.default_rng(4)
    pf, pc, nnz = _random_sparse(rng, 300, CAP, C)
    st = make_sparse_tensor(pf, pc, nnz=nnz, device="cpu")
    tconv.conv3d(st, torch.zeros(27, C, CO), 3)
    tconv.conv3d(st, torch.zeros(8, C, CO), 2, stride=2,
                 out_capacity=CAP // 2)
    for key in ((3, 3, 3), (1, 1, 1)), ((2, 2, 2), (2, 2, 2)):
        plan = st.kmaps[("plan", (1, 1, 1), key[0], key[1], (1, 1, 1))]
        bwd = tconv.plan_bwd_idx(plan)
        assert tconv.plan_bwd_idx(plan) is bwd and plan.bwd_idx is bwd
        np.testing.assert_array_equal(bwd.numpy(),
                                      tconv.invert_plan(plan).numpy())
        idx = plan.in_idx.numpy()
        for k in range(idx.shape[0]):
            j = np.nonzero(idx[k] >= 0)[0]
            np.testing.assert_array_equal(bwd.numpy()[k, idx[k, j]], j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_wgrad_plain_matches_dense_einsum(dtype):
    rng = np.random.default_rng(12)
    n, m, k, ci, co = 70, 50, 5, 4, 6
    feats = torch.from_numpy(rng.normal(size=(n, ci)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(m, co)).astype(np.float32)).to(dtype)
    bwd = rng.integers(-1, m, size=(k, n)).astype(np.int32)
    # dense one-hot of the map: sel[k, i, j] = 1 where bwd[k, i] == j
    sel = (bwd[:, :, None] == np.arange(m)[None, None, :]).astype(np.float64)
    want = np.einsum("ic,kij,jd->kcd", feats.double().numpy(), sel,
                     g.double().numpy())
    got = kernels.gather_wgrad(feats, g, torch.from_numpy(bwd))
    assert got.dtype == torch.float32 and got.shape == (k, ci, co)
    assert _rel(got.numpy(), want) < F32_TOL


def test_spdevoxelize_inverse_map_backward_matches_autograd():
    """As tests/test_conv_vjp.py::test_spdevoxelize_mirror_grad_parity: the
    window sum's backward over the mirrored map equals autograd of the plain
    form, padding rows and boundary cells included."""
    rng = np.random.default_rng(11)
    cap, c = 256, 9
    feats, coords, nnz = _random_sparse(rng, 200, cap, c, span=10, sort=True)
    coords_t = torch.from_numpy(coords)
    table = tcoords.build_table(coords_t, assume_sorted=True)
    offs = tcoords.kernel_offsets_np((3, 3, 3))
    nb_idx = tcoords.join_taps(table, coords_t, offs).T.contiguous()
    inv_nb = nb_idx[:, list(tconv.mirror_perm(offs))]
    nb, inv = nb_idx.numpy(), inv_nb.numpy()
    for k in range(nb.shape[1]):
        j = np.nonzero(inv[:, k] >= 0)[0]
        np.testing.assert_array_equal(nb[inv[j, k], k], j)
    w = torch.ones(nb_idx.shape)
    cot = torch.from_numpy(rng.normal(size=(cap, c)).astype(np.float32))
    grads, outs = [], []
    for kw in ({"inv_idx": inv_nb}, {}):
        f = torch.from_numpy(feats).requires_grad_()
        out = tops.spdevoxelize(f, nb_idx, w, **kw)
        out.backward(cot)
        grads.append(f.grad)
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    assert _rel(grads[0], grads[1]) < F32_TOL and float(grads[1].abs().max()) > 0


def test_aux_to_voxel_takes_the_inverse_map_only_for_odd_windows(monkeypatch):
    """r = 3 (symmetric offsets) hands spdevoxelize the mirrored map when a
    gradient is needed; r = 2 (seg) and inference do not."""
    from link_tpu_torch.ops import elk as telk
    rng = np.random.default_rng(2)
    pf, pc, nnz = _random_sparse(rng, 200, 256, 6, span=12, sort=True)
    seen = []
    real = tops.spdevoxelize

    def spy(feats, idx, weights, inv_idx=None):
        seen.append(inv_idx is not None)
        return real(feats, idx, weights, inv_idx=inv_idx)

    monkeypatch.setattr(telk.spops, "spdevoxelize", spy)
    grads = {}
    for r, grad in ((3, True), (2, True), (3, False)):
        f = torch.from_numpy(pf).requires_grad_(grad)
        st = make_sparse_tensor(f, pc, nnz=nnz, device="cpu", base_sorted=True)
        aux, idx, counts = telk.voxel_to_aux(st, 3, 128)
        out = telk.aux_to_voxel(aux, st, idx, counts, r).feats
        if grad:
            out.square().sum().backward()
            grads[r] = f.grad
    assert seen == [True, False, False]
    # and the inverse-map backward equals autograd of the plain form
    monkeypatch.setattr(telk, "mirror_perm", lambda offsets: None)
    f = torch.from_numpy(pf).requires_grad_()
    st = make_sparse_tensor(f, pc, nnz=nnz, device="cpu", base_sorted=True)
    aux, idx, counts = telk.voxel_to_aux(st, 3, 128)
    telk.aux_to_voxel(aux, st, idx, counts, 3).feats.square().sum().backward()
    assert seen[-1] is False
    assert _rel(grads[3], f.grad) < F32_TOL


def test_window_form_raises_when_a_gradient_is_asked():
    """A window-form conv trains (`WindowConv`), but where Ci != Co and the
    feature gradient's Co-wide window exceeds one chunk it raises instead
    of taking another form; its weight gradient alone still runs."""
    rng = np.random.default_rng(7)
    pf, pc, nnz = _random_sparse(rng, 300, CAP, C, sort=True)
    wide = 32                 # 3 rows of 128 B: over the 256 B chunk
    w = torch.from_numpy(rng.normal(size=(27, C, wide)).astype(np.float32))
    st = make_sparse_tensor(pf, pc, nnz=nnz, device="cpu", base_sorted=True)
    with torch.no_grad():
        want = tconv.conv3d(st, w, 3, prefer_window=True).feats
    plan = st.kmaps[("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))]
    assert tconv.uses_window(plan, st.feats, True)
    grad_st = st.replace(feats=st.feats.clone().requires_grad_())
    with pytest.raises(ValueError, match="chunk"):
        tconv.conv3d(grad_st, w, 3, prefer_window=True)
    # the weight gradient alone takes the window form, equal to the
    # gather form's
    grads = []
    for prefer in (True, False):
        wg = w.clone().requires_grad_()
        got = tconv.conv3d(st, wg, 3, prefer_window=prefer).feats
        got.sum().backward()
        assert _rel(got.detach(), want) < F32_TOL
        grads.append(wg.grad)
    assert _rel(grads[0], grads[1]) < F32_TOL
