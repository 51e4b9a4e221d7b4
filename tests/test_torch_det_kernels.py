"""Port vs JAX: the window-form conv twin, the lower-bound join, the
window-form plan and the spconv engine of the detection backbone.

Inputs come from numpy seeds and go through both packages. Integer plan
arrays (in_idx, base_pos, slot, groups, downsampled coords) are compared
exactly. Float32 conv outputs: max|port - ref| / max|ref| < 1e-5, the same
products summed in another order. bfloat16 outputs: both sides sum exact
bf16 products in float32 and round once, so they differ by at most one
bf16 ulp (2^-8 relative); bound 8e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.ops import pallas_kernels as pk
from link_tpu.sparse import conv as jconv
from link_tpu.sparse import coords as jc
from link_tpu.sparse import spconv_engine as jse
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as tc
from link_tpu_torch.sparse import spconv_engine as tse
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make

import oracles
from test_sorted_fastpath import sort_cloud
from test_sparse_core import pad_coords

F32_TOL = 1e-5
BF16_TOL = 8e-3


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _onehot_inputs(cap=512):
    """The inputs of tests/test_pallas_onehot.py:30-43: a sorted 2-batch
    cloud, 8 channels in, 16 out, its exact-search window plan."""
    rng = np.random.default_rng(33)
    coords, feats = oracles.random_cloud(rng, cap - 40, batch=2, channels=8)
    coords, feats = sort_cloud(coords, feats)
    cp = pad_coords(coords, cap)
    f = np.concatenate([feats, np.zeros((cap - len(coords), 8), np.float32)])
    w = (rng.standard_normal((27, 8, 16)) * .2).astype(np.float32)
    offsets = jc.kernel_offsets_np(3, stride=1)
    table = jc.build_table(jnp.asarray(cp), assume_sorted=True)
    _, base_pos, slot = jc.grouped_window_query(
        table, jnp.asarray(cp), offsets, 1, queries_sorted=True,
        identity_perm=True)
    groups = tuple(tuple(t for _, t in taps)
                   for _, taps in jc.offset_groups(offsets))
    return f, np.array(base_pos), np.array(slot), groups, w


def test_window_twin_matches_onehot_pallas_conv():
    """f32: the twin against `onehot_window_conv` in interpret mode."""
    f, base_pos, slot, groups, w = _onehot_inputs()
    want = np.asarray(pk.onehot_window_conv(
        jnp.asarray(f), jnp.asarray(base_pos), jnp.asarray(slot), groups,
        jnp.asarray(w), block_m=128, window=256, interpret=True))
    got = tk.window_conv(torch.from_numpy(f), torch.from_numpy(base_pos),
                         torch.from_numpy(slot), groups, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (512, 16)
    assert _rel(got.numpy(), want) < F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_twin_matches_win_apply_impl(dtype):
    """The twin against the XLA window apply `_win_apply_impl`, and against
    the gather form over the plan's in_idx (same function)."""
    f, base_pos, slot, groups, w = _onehot_inputs()
    jdt = jnp.dtype(dtype)
    want = np.asarray(jconv._win_apply_impl(
        jnp.asarray(f, jdt), jnp.asarray(w, jdt), jnp.asarray(base_pos),
        jnp.asarray(slot), groups, None), np.float32)
    tdt = getattr(torch, dtype)
    got = tk.window_conv(torch.from_numpy(f).to(tdt),
                         torch.from_numpy(base_pos), torch.from_numpy(slot),
                         groups, torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got.float().numpy(), want) < tol
    idx = np.full(slot.shape, -1, np.int32)
    for g, taps in enumerate(groups):
        for t in taps:
            idx[t] = np.where(slot[t] >= 0, base_pos[g] + slot[t], -1)
    gathered = tk.gather_conv(torch.from_numpy(f).to(tdt),
                              torch.from_numpy(idx),
                              torch.from_numpy(w).to(tdt))
    assert _rel(got.float().numpy(), gathered.float().numpy()) < tol


def test_window_twin_reads_zero_for_misses_and_rows_past_the_table():
    """slot -1, slot >= the window width and base + slot >= N all read a
    zero row (link_tpu's _window_table pads past the end with zeros)."""
    rng = np.random.default_rng(4)
    n, m, c, co = 10, 6, 3, 2
    f = rng.standard_normal((n, c)).astype(np.float32)
    w = rng.standard_normal((3, c, co)).astype(np.float32)
    groups = ((0, 1), (2,))
    base = np.array([[0, 8, 9, 4, 2, 5], [9, 9, 0, 1, 3, 3]], np.int32)
    slot = np.array([[0, 1, 1, -1, 1, 2],
                     [1, 1, -1, 0, -1, 0],
                     [0, 1, 0, 0, -1, 0]], np.int8)
    want = np.zeros((m, co), np.float32)
    for g, taps in enumerate(groups):
        for t in taps:
            for j in range(m):
                s = int(slot[t, j])
                row = base[g, j] + s
                if 0 <= s < 2 and row < n:
                    want[j] += f[row] @ w[t]
    got = tk.window_conv(torch.from_numpy(f), torch.from_numpy(base),
                         torch.from_numpy(slot), groups, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_window_conv_wrapper_takes_twin_on_cpu_and_refuses_other_devices():
    f, base_pos, slot, groups, w = _onehot_inputs()
    args = [torch.from_numpy(a) for a in (f, base_pos, slot)]
    got = tk.window_conv(args[0], args[1], args[2], groups,
                         torch.from_numpy(w))
    want = tk.window_conv_plain(args[0], args[1], args[2], groups,
                                torch.from_numpy(w))
    assert torch.equal(got, want)
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.window_conv(args[0].to("meta"), args[1].to("meta"),
                       args[2].to("meta"), groups,
                       torch.from_numpy(w).to("meta"))
    assert tk.window_conv.launches == 0


def test_lower_bound_mode_matches_searchsorted():
    """mode "lower_bound": for each base row + offset, the first table row
    whose key is >= the query, clamped to N - 1, for valid, absent and
    padding queries alike; JAX's lower_bound gives the same unclamped
    position."""
    rng = np.random.default_rng(12)
    coords, _ = oracles.random_cloud(rng, 900, span=(30, 30, 6), batch=2)
    coords = sort_cloud(coords)[0]
    cp = pad_coords(coords, len(coords) + 25)
    base = pad_coords(coords, len(coords) + 9)
    offs = np.array([[-1, -1, -1], [0, 1, 0], [1, 0, -1], [0, 0, 0]],
                    np.int32)
    q = np.concatenate([base[None, :, :3] + offs[:, None],
                        np.broadcast_to(base[None, :, 3:],
                                        (4, len(base), 1))], -1)
    table = tc.build_table(torch.from_numpy(cp), assume_sorted=True)
    got = tk.sorted_join(table.hi, table.lo, table.perm,
                         torch.from_numpy(base), offs,
                         mode="lower_bound").numpy()
    q_hi, q_lo = tc.pack_coords(torch.from_numpy(q.reshape(-1, 4)))
    tkey = tk.key64(table.hi, table.lo).numpy()
    qkey = tk.key64(q_hi, q_lo).numpy()
    want = np.minimum(np.searchsorted(tkey, qkey, side="left"), len(cp) - 1)
    np.testing.assert_array_equal(got, want.reshape(4, -1))
    jpos = np.asarray(jc.lower_bound(jnp.asarray(table.hi.numpy()),
                                     jnp.asarray(table.lo.numpy()),
                                     jnp.asarray(q_hi.numpy()),
                                     jnp.asarray(q_lo.numpy())))
    np.testing.assert_array_equal(got,
                                  np.minimum(jpos, len(cp) - 1).reshape(4, -1))
    exact = tk.sorted_join(table.hi, table.lo, table.perm,
                           torch.from_numpy(base), offs).numpy()
    hit = exact >= 0
    np.testing.assert_array_equal(got[hit], exact[hit])
    with pytest.raises(ValueError, match="mode"):
        tk.sorted_join(table.hi, table.lo, table.perm,
                       torch.from_numpy(base), offs, mode="x")


def _det_level(seed, cap, span=(24, 24, 10)):
    """A sorted det-like level: unique unit-lattice coords, batch 1, padded
    to `cap` rows."""
    rng = np.random.default_rng(seed)
    coords, _ = oracles.random_cloud(rng, cap - 50, span=span, batch=1)
    coords = sort_cloud(coords)[0]
    return pad_coords(coords, cap), len(coords)


@pytest.mark.parametrize("kind", ["subm_self_query", "strided"])
def test_grouped_window_query_matches_jax(kind):
    """The port's exact join (join_taps) and its window join (window_join)
    give the in_idx, base_pos and slot of the JAX exact-search form
    exactly, and every hit sits at base_pos[g(t)] + slot[t]."""
    cp, n = _det_level(7, 1024)
    if kind == "subm_self_query":
        offsets = jc.kernel_offsets_np(3)
        base = cp
        kw = dict(self_query=True)
    else:
        offsets = jse._tap_offsets((3, 3, 3)) - np.array([1, 1, 1])
        half = np.unique(np.where(cp[:n, :3] >= 0, cp[:n, :3] // 2, 0),
                         axis=0)
        half = sort_cloud(np.concatenate(
            [half, np.zeros((len(half), 1), np.int32)], 1).astype(np.int32))[0]
        base = pad_coords(half * np.array([2, 2, 2, 1], np.int32), 600)
        kw = {}
    jtab = jc.build_table(jnp.asarray(cp), assume_sorted=True, direct=False)
    assert jtab.grid is None and jtab.direct is None     # exact search
    j_idx, j_base, j_slot = jc.grouped_window_query(
        jtab, jnp.asarray(base), offsets, 1, queries_sorted=True,
        identity_perm=True, **kw)
    ttab = tc.build_table(torch.from_numpy(cp), assume_sorted=True)
    t_idx = tc.join_taps(ttab, torch.from_numpy(base), offsets)
    w_idx, t_base, t_slot = tc.window_join(ttab, torch.from_numpy(base),
                                           offsets)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(w_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_base.numpy(), np.asarray(j_base))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    assert t_slot.dtype == torch.int8 and t_base.dtype == torch.int32
    glist = tc.offset_groups(offsets)
    assert glist == jc.offset_groups(offsets)
    for g, (_, taps) in enumerate(glist):
        for _, t in taps:
            s = t_slot[t].long()
            hit = s >= 0
            assert torch.equal((t_base[g].long() + s)[hit],
                               t_idx[t][hit].long())
            assert torch.equal(hit, t_idx[t] >= 0)
    assert int((t_idx >= 0).sum()) > base.shape[0]


def test_offset_grouping_matches_jax():
    for offs, q in ((jc.kernel_offsets_np(3), 1),
                    (jc.kernel_offsets_np(3, stride=2), 2),
                    (jc.kernel_offsets_np(2, stride=4), 4),
                    (jc.kernel_offsets_np(3, stride=2), 1),
                    (jse._tap_offsets((1, 1, 3)), 1)):
        assert tc.offset_groups(offs) == jc.offset_groups(offs)
        assert tc.can_group_offsets(offs, q) == jc.can_group_offsets(offs, q)
    for g, c, isz in ((3, 5, 2), (3, 16, 4), (3, 32, 4), (3, 32, 2),
                      (3, 64, 2), (3, 128, 4)):
        assert tconv.window_chunk(g, c, isz) == jconv.window_chunk(g, c, isz)


@pytest.mark.parametrize("dtype,ci,window", [
    ("float32", 16, True), ("bfloat16", 32, True), ("float32", 32, False),
    ("bfloat16", 64, False)])
def test_subm_conv3d_window_plan_and_dispatch_match_jax(dtype, ci, window):
    """conv3d with prefer_window: the plan's window arrays equal the JAX
    plan's (exact search), the dispatch follows link_tpu's rule
    (C * itemsize * 3 <= 256 B), and the outputs agree."""
    cp, n = _det_level(9, 700, span=(16, 16, 8))
    rng = np.random.default_rng(ci)
    f = rng.standard_normal((700, ci)).astype(np.float32)
    w = (rng.standard_normal((27, ci, 8)) / np.sqrt(27 * ci)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    js = j_make(jnp.asarray(f, jdt), cp, nnz=n, base_sorted=True)
    js.kmaps[("table", (1, 1, 1))] = jc.build_table(
        jnp.asarray(js.coords), assume_sorted=True, direct=False)
    ts = t_make(torch.from_numpy(f).to(tdt), cp, nnz=n, base_sorted=True,
                device="cpu")
    want = jconv.conv3d(js, jnp.asarray(w), 3, prefer_window=True)
    calls = []
    orig = (tk.window_conv, tk.gather_conv)

    def spy(kind, fn):
        def wrapped(*a):
            calls.append(kind)
            return fn(*a)
        return wrapped

    try:
        tk.window_conv = spy("window", orig[0])
        tk.gather_conv = spy("gather", orig[1])
        got = tconv.conv3d(ts, torch.from_numpy(w), 3, prefer_window=True)
    finally:
        tk.window_conv, tk.gather_conv = orig
    assert calls == ["window" if window else "gather"]
    key = ("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))
    jp, tp = js.kmaps[key], ts.kmaps[key]
    for name in ("in_idx", "base_pos", "slot"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.groups, tp.self_group, tp.mirror, tp.window) == (
        jp.groups, jp.self_group, jp.mirror, jp.window)
    assert tconv.uses_window(tp, ts.feats, True) == window
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got.feats.float().numpy()[:n],
                np.asarray(want.feats, np.float32)[:n]) < tol


def _spy_joins(monkeypatch):
    modes = []
    orig = tk.sorted_join

    def spy(*a, mode="exact", **kw):
        modes.append(mode)
        return orig(*a, mode=mode, **kw)

    monkeypatch.setattr(tk, "sorted_join", spy)
    return modes


def test_window_form_only_for_callers_that_prefer_it(monkeypatch):
    """A submanifold conv that does not prefer the window form (seg, ELK
    local_mix) builds its plan with one exact join and no window arrays;
    a later conv on the same plan that prefers it adds them with one
    window join, equal to the JAX plan's; a conv that prefers it from the
    start builds the plan and its window arrays in one window join; a
    dilated conv never gets them."""
    cp, n = _det_level(9, 700, span=(16, 16, 8))
    rng = np.random.default_rng(2)
    f = rng.standard_normal((700, 8)).astype(np.float32)
    w = (rng.standard_normal((27, 8, 8)) / np.sqrt(27 * 8)).astype(np.float32)
    ts = t_make(f, cp, nnz=n, base_sorted=True, device="cpu")
    modes = _spy_joins(monkeypatch)
    plain = tconv.conv3d(ts, torch.from_numpy(w), 3)
    key = ("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))
    assert modes == ["exact"] and ts.kmaps[key].base_pos is None
    win = tconv.conv3d(ts, torch.from_numpy(w), 3, prefer_window=True)
    assert modes == ["exact", "window"]
    tconv.conv3d(ts, torch.from_numpy(w), 3, prefer_window=True)
    assert len(modes) == 2
    tp = ts.kmaps[key]
    js = j_make(jnp.asarray(f), cp, nnz=n, base_sorted=True)
    js.kmaps[("table", (1, 1, 1))] = jc.build_table(
        jnp.asarray(js.coords), assume_sorted=True, direct=False)
    jconv.conv3d(js, jnp.asarray(w), 3, prefer_window=True)
    jp = js.kmaps[key]
    for name in ("in_idx", "base_pos", "slot"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.groups, tp.self_group) == (jp.groups, jp.self_group)
    assert _rel(win.feats.numpy()[:n], plain.feats.numpy()[:n]) < F32_TOL
    tconv.conv3d(ts, torch.from_numpy(w), 3, dilation=2, prefer_window=True)
    assert modes[2:] == ["exact"]
    assert ts.kmaps[key[:4] + ((2, 2, 2),)].base_pos is None
    first = t_make(f, cp, nnz=n, base_sorted=True, device="cpu")
    del modes[:]
    tconv.conv3d(first, torch.from_numpy(w), 3, prefer_window=True)
    assert modes == ["window"]
    for name in ("in_idx", "base_pos", "slot"):
        assert torch.equal(getattr(first.kmaps[key], name),
                           getattr(tp, name))


SPCONV_CASES = {"down_k3s2p1": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                "down_zpad0": ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
                "extra_z": ((1, 1, 3), (1, 1, 2), (0, 0, 0))}


@pytest.mark.parametrize("case", sorted(SPCONV_CASES))
@pytest.mark.parametrize("cap", [3000, 200])
def test_spconv_downsample_and_plan_match_jax(case, cap):
    """Output coords, order and nnz equal link_tpu's max-pool dedup
    (including truncation at a tight capacity); the strided plan's in_idx
    equals the JAX plan's built on an exact-search table, and the plan
    carries no window arrays (no mirror, so never the window form); at the
    full capacity the conv outputs agree too."""
    ks, st, pd = SPCONV_CASES[case]
    in_shape = (24, 24, 10)
    cp, n = _det_level(11, 900, span=in_shape)
    out_shape = jse.spconv_out_shape(in_shape, ks, st, pd)
    assert tse.spconv_out_shape(in_shape, ks, st, pd) == out_shape
    j_out, j_nnz = jse.spconv_downsample(jnp.asarray(cp), ks, st, pd,
                                         out_shape, cap, batch_size=1,
                                         in_shape=in_shape)
    t_out, t_nnz = tse.spconv_downsample(torch.from_numpy(cp), ks, st, pd,
                                         out_shape, cap)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert int(t_nnz) == int(j_nnz) and (int(t_nnz) == cap) == (cap == 200)

    jtab = jc.build_table(jnp.asarray(cp), assume_sorted=True, direct=False)
    jp = jse.build_spconv_plan(jnp.asarray(cp), j_out, j_nnz, ks, st, pd,
                               900, in_sorted=True, out_sorted=True,
                               table=jtab)
    tp = tse.build_spconv_plan(torch.from_numpy(cp), t_out, t_nnz, ks, st,
                               pd, 900, in_sorted=True)
    np.testing.assert_array_equal(tp.in_idx.numpy(), np.asarray(jp.in_idx))
    assert tp.mirror is None and jp.mirror is None
    assert tp.base_pos is None and tp.slot is None and tp.groups is None
    if cap != 3000:
        return

    rng = np.random.default_rng(3)
    k = int(np.prod(ks))
    f = rng.standard_normal((900, 8)).astype(np.float32)
    w = (rng.standard_normal((k, 8, 16)) / np.sqrt(8 * k)).astype(np.float32)
    js = j_make(f, cp, nnz=n, base_sorted=True)
    ts = t_make(f, cp, nnz=n, base_sorted=True, device="cpu")
    jy, jshape = jse.spconv3d(js, jnp.asarray(w), ks, in_shape, stride=st,
                              padding=pd, out_capacity=cap, batch_size=1)
    ty, tshape = tse.spconv3d(ts, torch.from_numpy(w), ks, in_shape,
                              stride=st, padding=pd, out_capacity=cap,
                              batch_size=1)
    assert tshape == jshape == out_shape
    m = int(t_nnz)
    assert _rel(ty.feats.numpy()[:m], np.asarray(jy.feats)[:m]) < F32_TOL
    assert ty.coords_sorted and ty.stride == (1, 1, 1) and not ty.kmaps


def test_to_dense_bev_and_level_table_match_jax():
    cp, n = _det_level(13, 500, span=(12, 10, 2))
    rng = np.random.default_rng(5)
    f = rng.standard_normal((500, 6)).astype(np.float32)
    want = np.asarray(jse.to_dense_bev(j_make(f, cp, nnz=n), (12, 10, 2), 1))
    ts = t_make(f, cp, nnz=n, base_sorted=True, device="cpu")
    got = tse.to_dense_bev(ts, (12, 10, 2), 1)
    assert got.shape == (1, 12, 10, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # the level table carries the lattice extent where link_tpu builds
    # its RankGrid (and the ELK block then takes its dense aux path)
    tse.ensure_level_table(ts, (12, 10, 2), 1)
    js = j_make(f, cp, nnz=n, base_sorted=True)
    jse.ensure_level_table(js, (12, 10, 2), 1)
    jg = js.kmaps[("table", (1, 1, 1))].grid
    assert ts.kmaps[("table", (1, 1, 1))].grid == (
        jg.nx * jg.quantum, jg.ny * jg.quantum, jg.nz * jg.quantum, jg.nb)
