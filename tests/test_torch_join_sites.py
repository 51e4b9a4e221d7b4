"""Port vs JAX: the join sites on `sorted_join`'s contract (queries formed
from base rows, tap offsets and a multiplier), and the det ELK at full
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
scale.

Each join case runs the port's wrapper (on the CPU its plain twin, the
contract the CUDA kernel is held to on the card) and the JAX references on
the same numpy inputs made from a seed: `pallas_join(interpret=True)` on
JAX-packed keys, `CoordTable.query`, `lower_bound` and
`grouped_window_query`. Every output is an integer array and must be
exactly equal.

The dispatch-mode test checks that a join site runs no aten operator
outside the `sorted_join` wrapper: no query, offset or anchor array is
built around the kernel.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from link_tpu.ops import pallas_kernels as pk
from link_tpu.sparse import coords as jc
from link_tpu.sparse import spconv_engine as jse
from link_tpu_torch.models.elk import ELKBlock as TELKBlock
from link_tpu_torch.ops import elk as telk
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.sparse import coords as tc
from link_tpu_torch.sparse import spconv_engine as tse
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make

SENT = -(2**20)
TSELK = os.path.join(os.path.dirname(__file__), "goldens",
                     "tselk_cos_fullscale.npz")
GOLDEN_TOL = 2e-4       # as tests/test_golden_parity.py holds the JAX block
DET_CAP = 163840        # the det level-0 capacity (models/scn.py)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _key_order(c):
    """Rows of c in pack-key (b, z, y, x) order."""
    return c[np.lexsort((c[:, 0], c[:, 1], c[:, 2], c[:, 3]))]


def _lattice(rng, n, quantum=1, span=16, nb=2):
    """Unique (x, y, z, b) rows with x on multiples of `quantum`, in key
    order."""
    pts = np.stack([rng.integers(0, span, n) * quantum,
                    rng.integers(0, span, n), rng.integers(0, 8, n),
                    rng.integers(0, nb, n)], 1).astype(np.int32)
    return _key_order(np.unique(pts, axis=0))


def _pad(c, extra):
    return np.concatenate([c, np.full((extra, 4), SENT, np.int32)])


# name -> (table rows, table sorted?, base rows, offsets, quantum)
def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    o3 = jc.kernel_offsets_np(3)
    c = _lattice(rng, 700)
    if name == "perm":                          # non-identity perm
        return c[rng.permutation(len(c))], False, _pad(c, 9), o3, 1
    if name == "unsorted_base":
        base = _pad(c, 9)
        return _pad(c, 5), True, base[rng.permutation(len(base))], o3, 1
    if name == "mid_sentinels":
        base = _pad(c, 0)
        base[rng.choice(len(base), 40, replace=False)] = SENT
        return _pad(c, 5), True, base, o3, 1
    if name == "out_of_range":
        edge = np.array([[-512, 3, 3, 0], [-513, 3, 3, 0], [16383 - 512, 3,
                          3, 1], [16382 - 512, 3, 3, 1], [3, -512, 3, 0],
                         [3, 3, 4095 - 512, 1], [3, 3, -512, 0],
                         [3, 3, 3, -1], [20000, 0, 0, 0]], np.int32)
        t = np.concatenate([c, edge[:8]])
        base = np.concatenate([c[:300], edge, c[300:]])
        return _pad(t, 5)[rng.permutation(len(t) + 5)], False, base, o3, 1
    if name in ("quantum2", "quantum4"):
        q = int(name[-1])
        c = _lattice(rng, 700, quantum=q)
        return _pad(c, 5), True, _pad(c, 5), jc.kernel_offsets_np(
            3, stride=(q, 1, 1)), q
    if name == "elk_r2":                        # x-major even taps
        return _pad(c, 7), True, _pad(c, 7), jc.kernel_offsets_np(2), 1
    if name == "k1":
        return _pad(c, 7), True, _pad(c, 7), np.zeros((1, 3), np.int32), 1
    raise KeyError(name)


EXACT_CASES = ["perm", "unsorted_base", "mid_sentinels", "out_of_range",
               "quantum2", "quantum4", "elk_r2", "k1"]


def _queries(base, offsets, mult=(1, 1, 1)):
    xyz = base[None, :, :3] * np.asarray(mult, np.int32) + offsets[:, None]
    b = np.broadcast_to(base[None, :, 3:], xyz.shape[:2] + (1,))
    return np.concatenate([xyz, b], -1).astype(np.int32)


@pytest.mark.parametrize("name", EXACT_CASES)
def test_exact_join_matches_jax(name):
    """mode "exact" against CoordTable.query and pallas_join on the same
    queries; with offsets None, the K = 1 zero-offset join of
    `CoordTable.query`."""
    rows, srt, base, offs, _ = _case(name)
    q = _queries(base, offs)
    jtab = jc.build_table(jnp.asarray(rows), assume_sorted=srt, direct=False)
    want = np.asarray(jtab.query(jnp.asarray(q)))
    q_hi, q_lo = jc.pack_coords(jnp.asarray(q.reshape(-1, 4)))
    want_pallas = np.asarray(pk.pallas_join(
        jtab.hi, jtab.lo, jtab.perm, q_hi, q_lo, block_q=512,
        interpret=True)).reshape(want.shape)
    np.testing.assert_array_equal(want_pallas, want)
    ttab = tc.build_table(_t(rows), assume_sorted=srt)
    got = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, _t(base), offs)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tc.join_taps(ttab, _t(base), offs).numpy(), want)
    if name == "k1":
        np.testing.assert_array_equal(ttab.query(_t(base)).numpy(), want[0])
        np.testing.assert_array_equal(
            tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, _t(base)).numpy(),
            want[0])
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("name", EXACT_CASES)
def test_lower_bound_matches_jax(name):
    """mode "lower_bound": JAX's lower_bound of each packed query,
    clamped to N - 1; perm is not read."""
    rows, srt, base, offs, _ = _case(name)
    jtab = jc.build_table(jnp.asarray(rows), assume_sorted=srt, direct=False)
    q = _queries(base, offs)
    q_hi, q_lo = jc.pack_coords(jnp.asarray(q.reshape(-1, 4)))
    want = np.minimum(np.asarray(jc.lower_bound(jtab.hi, jtab.lo, q_hi,
                                                q_lo)),
                      len(rows) - 1).reshape(q.shape[:2])
    ttab = tc.build_table(_t(rows), assume_sorted=srt)
    got = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, _t(base), offs,
                         mode="lower_bound")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["sorted", "quantum2", "quantum4",
                                  "padding_anchors"])
def test_window_join_matches_grouped_window_query(name):
    """mode "window" (`window_join`): in_idx, base_pos and slot of JAX's
    grouped_window_query (exact-search table, identity perm), the padding
    queries' base rows pinned to their group's last valid base."""
    rng = np.random.default_rng(sum(map(ord, name)))
    q = int(name[-1]) if name.startswith("quantum") else 1
    c = _lattice(rng, 900, quantum=q)
    pad = 60 if name == "padding_anchors" else 11
    cp = _pad(c, pad)
    offs = jc.kernel_offsets_np(3, stride=(q, 1, 1))
    jtab = jc.build_table(jnp.asarray(cp), assume_sorted=True, direct=False)
    j_idx, j_base, j_slot = jc.grouped_window_query(
        jtab, jnp.asarray(cp), offs, q, queries_sorted=True,
        identity_perm=True)
    ttab = tc.build_table(_t(cp), assume_sorted=True)
    idx, base, slot = tc.window_join(ttab, _t(cp), offs)
    assert (idx.dtype, base.dtype, slot.dtype) == (torch.int32, torch.int32,
                                                   torch.int8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(base.numpy(), np.asarray(j_base))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    # padding rows sit at the group's largest valid base, not at N - 1
    assert (base.numpy()[:, -pad:] <= len(c)).all()


def test_window_join_on_any_input_equals_the_plain_sequence():
    """mode "window" on inputs outside the window form's preconditions
    (unsorted base rows, sentinels in the middle, a shuffled table) still
    equals the plain sequence: the exact join, the anchors' lower bounds
    with the padding ones pinned, and the slots against them."""
    for name in ("perm", "unsorted_base", "mid_sentinels", "out_of_range"):
        rows, srt, base, offs, _ = _case(name)
        ttab = tc.build_table(_t(rows), assume_sorted=srt)
        idx, bpos, slot = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm,
                                         _t(base), offs, mode="window")
        np.testing.assert_array_equal(
            idx.numpy(), tk.sorted_join(ttab.hi, ttab.lo, ttab.perm,
                                        _t(base), offs).numpy())
        glist = tc.offset_groups(offs)
        anchors = np.array([a for a, _ in glist], np.int32)
        lb = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, _t(base), anchors,
                            mode="lower_bound").numpy()
        valid = tc.pack_coords(_t(_queries(base, anchors).reshape(-1, 4)))[
            0].numpy().reshape(lb.shape) != tc.INT32_MAX
        last = np.where(valid, lb, 0).max(1, keepdims=True)
        np.testing.assert_array_equal(bpos.numpy(),
                                      np.where(valid, lb, last))
        for g, (_, taps) in enumerate(glist):
            for _, t in taps:
                i = idx.numpy()[t].astype(np.int64)
                want = np.where(i >= 0, i - bpos.numpy()[g], -1)
                np.testing.assert_array_equal(slot.numpy()[t],
                                              want.astype(np.int8))


@pytest.mark.parametrize("case", ["down_k3s2p1", "down_zpad0", "extra_z"])
def test_down_plan_with_multiplier_matches_jax(case):
    """`build_spconv_plan`'s join, base j * s formed in the kernel from the
    output rows and the stride: the in_idx of the JAX plan, and the join
    of the JAX table on the queries j * s - p + t."""
    ks, st, pd = {"down_k3s2p1": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                  "down_zpad0": ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
                  "extra_z": ((1, 1, 3), (1, 1, 2), (0, 0, 0))}[case]
    rng = np.random.default_rng(len(case))
    c = _lattice(rng, 800, span=24, nb=1)
    cp = _pad(c, 40)
    in_shape = (24, 24, 8)
    out_shape = jse.spconv_out_shape(in_shape, ks, st, pd)
    t_out, t_nnz = tse.spconv_downsample(_t(cp), ks, st, pd, out_shape, 900)
    taps = tse._tap_offsets(ks) - np.asarray(pd, np.int32)
    jtab = jc.build_table(jnp.asarray(cp), assume_sorted=True, direct=False)
    want = np.asarray(jtab.query(jnp.asarray(
        _queries(t_out.numpy(), taps, st))))
    jp = jse.build_spconv_plan(jnp.asarray(cp), jnp.asarray(t_out.numpy()),
                               jnp.asarray(t_nnz.numpy()), ks, st, pd, 900,
                               in_sorted=True, out_sorted=True, table=jtab)
    np.testing.assert_array_equal(np.asarray(jp.in_idx), want)
    ttab = tc.build_table(_t(cp), assume_sorted=True)
    got = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, t_out, taps, mult=st)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = tse.build_spconv_plan(_t(cp), t_out, t_nnz, ks, st, pd, 900,
                                 in_sorted=True, table=ttab)
    np.testing.assert_array_equal(plan.in_idx.numpy(), want)
    assert (want >= 0).sum() > int(t_nnz)


class _AtenOps(TorchDispatchMode):
    """Records the aten operators dispatched while it is active, except
    inside the `sorted_join` wrapper."""

    def __init__(self):
        super().__init__()
        self.ops, self.depth = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0 and func.namespace == "aten":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("site", ["join_taps", "query", "window_join",
                                  "spconv_plan", "aux_window"])
def test_join_site_runs_no_aten_op_outside_the_kernel(site, monkeypatch):
    """Each join site is one `sorted_join` call and nothing else: no aten
    operator runs outside the wrapper (on the card the wrapper's
    allocations and its one launch, two for the window form)."""
    rng = np.random.default_rng(3)
    c = _pad(_lattice(rng, 400), 8)
    table = tc.build_table(_t(c), assume_sorted=True)
    base = _t(c)
    mode = _AtenOps()
    calls = []
    real = tk.sorted_join

    def spy(*a, **kw):
        calls.append(kw.get("mode", "exact"))
        mode.depth += 1
        try:
            return real(*a, **kw)
        finally:
            mode.depth -= 1

    monkeypatch.setattr(tk, "sorted_join", spy)
    offs = tc.kernel_offsets_np(3)
    with mode:
        if site == "join_taps":
            tc.join_taps(table, base, offs)
        elif site == "query":
            table.query(base)
        elif site == "window_join":
            tc.window_join(table, base, offs)
        elif site == "spconv_plan":
            tse.build_spconv_plan(base, base, None, (3, 3, 3), (2, 2, 2),
                                  (1, 1, 1), len(c), in_sorted=True,
                                  table=table)
        else:
            # the ELK window's join, as aux_to_voxel makes it
            tc.join_taps(table, base, tc.kernel_offsets_np((2, 2, 2)))
    assert mode.ops == []
    assert calls == (["window"] if site == "window_join" else ["exact"])


@pytest.mark.skipif(not os.path.exists(TSELK), reason="no det golden")
@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_tselk_fullscale_golden(path):
    """The reference TSELKBlock golden at the det capacity (160,000 voxels
    in 163,840 rows; cos basis, det channel grouping, r = 3), through both
    aux paths: the det ELK's joins at real spans, as
    tests/test_golden_parity.py holds the JAX block (slow-marked there)."""
    g = np.load(TSELK)
    coords, feats, want = g["coords"], g["feats"], g["out"]
    inc, block_sz = int(g["inc"]), int(g["block_sz"])
    sd = {k[3:].replace("__", "."): g[k] for k in g.files
          if k.startswith("sd_")}
    n = len(coords)
    cpad = np.full((DET_CAP, 4), SENT, np.int32)
    fpad = np.zeros((DET_CAP, inc), np.float32)
    cpad[:n], fpad[:n] = coords, feats
    ext = None
    if path == "dense":
        ext = tuple(int(v) for v in coords[:, :3].max(0) + 1) + (
            int(coords[:, 3].max()) + 1,)
    st = t_make(fpad, cpad, nnz=n, grid_extent=ext, device="cpu")
    assert (telk.use_dense_aux(st, block_sz, 3, 2 * inc) is not None) == (
        path == "dense")
    block = TELKBlock(inc, aux_capacity=DET_CAP, baseop="cos",
                      det_grouping=True, device="cpu")
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = block(st, block_sz, 3).feats.numpy()[:n]
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert np.isfinite(got).all() and err < GOLDEN_TOL, (
        f"tselk fullscale {path} rel err {err}")
