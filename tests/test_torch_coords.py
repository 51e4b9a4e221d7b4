"""Port vs JAX: coordinate keys, dedup, tap order and the sorted-key join.

Inputs are made with numpy from a seed and handed to both packages. Every
comparison here is on integers and must be exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.ops import pallas_kernels as pk
from link_tpu.sparse import coords as jc
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.sparse import coords as tc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SENT = -(2**20)


def _cloud(rng, n, span=24, nb=2, pad=0, odd=0):
    """Unique (x, y, z, b) rows in [0, span)^3 x [0, nb), shuffled, plus
    `pad` sentinel rows and `odd` rows outside the packable range."""
    pts = np.stack([rng.integers(0, span, n), rng.integers(0, span, n),
                    rng.integers(0, span, n), rng.integers(0, nb, n)],
                   1).astype(np.int32)
    pts = np.unique(pts, axis=0)
    pts = pts[rng.permutation(len(pts))]
    extra = [np.full((pad, 4), SENT, np.int32)]
    if odd:
        bad = np.array([[20000, 0, 0, 0], [0, -600, 0, 0], [0, 0, 4000, 0],
                        [0, 0, 0, -1], [-513, 3, 3, 0], [-512, 3, 3, 1],
                        [16383 - 512, 3, 3, 0], [3, 3, 4095 - 512, 1]],
                       np.int32)
        extra.append(bad[:odd])
    return np.concatenate([pts] + extra)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("pad,odd", [(0, 0), (17, 0), (5, 8)])
def test_pack_coords_matches_jax(pad, odd):
    c = _cloud(np.random.default_rng(pad + odd), 300, pad=pad, odd=odd)
    jh, jl = jc.pack_coords(jnp.asarray(c))
    th, tl = tc.pack_coords(_t(c))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert th.dtype == torch.int32 and tl.dtype == torch.int32


def test_sort_by_key_is_stable_lexicographic():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 6, 500).astype(np.int32)
    lo = rng.integers(0, 6, 500).astype(np.int32)
    hi[:20] = lo[:20] = 2**31 - 1
    pay = np.arange(500, dtype=np.int32)
    want = [np.asarray(a) for a in jc.sort_by_key(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay))]
    got = tc.sort_by_key(_t(hi), _t(lo), _t(pay))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("cap_frac", [1.5, 1.0, 0.6])
def test_unique_coords_matches_jax(cap_frac):
    rng = np.random.default_rng(11)
    base = _cloud(rng, 200, span=10, pad=9, odd=3)
    dup = base[rng.integers(0, len(base), 150)]          # repeats + pads
    c = np.concatenate([base, dup])[rng.permutation(len(base) + 150)]
    n_unique = len(np.unique(base[:len(base) - 12], axis=0))
    cap = int(n_unique * cap_frac)                      # 0.6: overflow
    jo, ji, jn = jc.unique_coords(jnp.asarray(c), cap)
    to, ti, tn = tc.unique_coords(_t(c), cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn) == min(n_unique, cap)


@pytest.mark.parametrize("size,stride,dilation", [
    (3, 1, 1), (2, 1, 1), (3, 2, 1), (2, 4, 1), (3, 1, 2),
    ((3, 1, 3), 1, 1), ((2, 2, 1), (1, 2, 4), 1), (5, 1, 1)])
def test_kernel_offsets_match_jax(size, stride, dilation):
    np.testing.assert_array_equal(
        tc.kernel_offsets_np(size, stride, dilation),
        jc.kernel_offsets_np(size, stride, dilation))


def test_join_twin_matches_pallas_join():
    """The join of base rows + offsets (queries formed by `sorted_join`
    itself) against a shuffled cloud's table (non-identity perm) equals
    pallas_join on the JAX-packed queries: hits, absent keys, padding
    rows (INT32_MAX hi always misses) and rows outside the packable
    range."""
    rng = np.random.default_rng(70)
    c = _cloud(rng, 1000, span=14)
    n = len(c)
    jtab = jc.build_table(jnp.asarray(c))
    base = np.concatenate([c[rng.integers(0, n, 350)],
                           _cloud(rng, 350, span=20, pad=9, odd=8)])
    base = base[rng.permutation(len(base))]
    offs = np.array([[0, 0, 0], [1, -1, 0], [-2, 0, 1]], np.int32)
    q = np.concatenate([base[None, :, :3] + offs[:, None],
                        np.broadcast_to(base[None, :, 3:],
                                        (3, len(base), 1))], -1)
    q_hi, q_lo = jc.pack_coords(jnp.asarray(q.reshape(-1, 4)))
    want = np.asarray(pk.pallas_join(
        jtab.hi, jtab.lo, jtab.perm, q_hi, q_lo, block_q=256,
        interpret=True)).reshape(3, -1)
    ttab = tc.build_table(_t(c))
    got = tk.sorted_join(ttab.hi, ttab.lo, ttab.perm, _t(base), offs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > len(base) // 3
    assert (want < 0).sum() > len(base) // 3


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_table_query_matches_jax(assume_sorted):
    rng = np.random.default_rng(5 + assume_sorted)
    c = _cloud(rng, 900, span=14, pad=40)
    if assume_sorted:
        hi, lo = jc.pack_coords(jnp.asarray(c))
        c = c[np.lexsort((np.asarray(lo), np.asarray(hi)))]
    offs = jc.kernel_offsets_np(3)
    q = (c[None, :, :3] + offs[:, None, :])
    q = np.concatenate([q, np.broadcast_to(c[None, :, 3:], q.shape[:2] + (1,))],
                       -1).astype(np.int32)
    q[:, -40:] = SENT                                   # sentinel queries
    want = np.asarray(jc.build_table(jnp.asarray(c), assume_sorted=assume_sorted)
                      .query(jnp.asarray(q)))
    got = tc.build_table(_t(c), assume_sorted=assume_sorted).query(_t(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


def test_wrappers_take_twins_on_cpu_and_refuse_other_devices():
    rng = np.random.default_rng(1)
    c = _cloud(rng, 64)
    table = tc.build_table(_t(c))
    before = (tk.sorted_join.launches, tk.gather_conv.launches)
    out = tk.sorted_join(table.hi, table.lo, table.perm, _t(c))
    np.testing.assert_array_equal(out.numpy(), np.arange(len(c)))
    feats = torch.ones((5, 4))
    idx = torch.tensor([[0, -1, 4]], dtype=torch.int32)
    y = tk.gather_conv(feats, idx, torch.ones((1, 4, 3)))
    np.testing.assert_array_equal(y.numpy(), [[4] * 3, [0] * 3, [4] * 3])
    assert (tk.sorted_join.launches, tk.gather_conv.launches) == before
    # a tensor that is neither on the CPU nor on a CUDA device raises
    meta = table.hi.to("meta")
    with pytest.raises(ValueError):
        tk.sorted_join(meta, meta, meta, _t(c).to("meta"))
    with pytest.raises(ValueError):
        tk.gather_conv(feats.to("meta"), idx.to("meta"),
                       torch.ones((1, 4, 3), device="meta"))
