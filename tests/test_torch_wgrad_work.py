"""The weight-gradient work list of `gather_wgrad` (link_tpu_torch/ops/
kernels.py, `wgrad_work_list`), on the CPU.

The list holds every hit (input row i, output row bwd_idx[k, i]) of an
inverse kernel map, tap-major and in row order within a tap, with each tap's
range in `tap_off`. The card builds it with three small kernels, checked
against the plain twin tested here by `chip_smoke.py`. These tests hold the
twin against a brute-force numpy build, emulate the kernel's cut of the list
into work items of H hits (an item never crosses a tap; the scratch is sized
by ceil(K N / H) + K) and its in-order sum of the items, and check that a
plan builds its list once and every conv sharing the plan reuses it.
"""

import numpy as np
import pytest
import torch

from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.tensor import make_sparse_tensor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def brute_force(bwd: np.ndarray):
    k, n = bwd.shape
    hit_i, hit_j, tap_off = [], [], [0]
    for kk in range(k):
        for i in range(n):
            if bwd[kk, i] >= 0:
                hit_i.append(i)
                hit_j.append(bwd[kk, i])
        tap_off.append(len(hit_i))
    return (np.asarray(hit_i, np.int32), np.asarray(hit_j, np.int32),
            np.asarray(tap_off, np.int32))


def random_map(k, n, m, density, seed):
    rng = np.random.default_rng(seed)
    bwd = rng.integers(0, m, size=(k, n)).astype(np.int32)
    bwd[rng.random((k, n)) >= density] = -1
    return bwd


def check_list(bwd: np.ndarray):
    work = kernels.wgrad_work_list(torch.from_numpy(bwd))
    hi, hj, off = brute_force(bwd)
    k, n = bwd.shape
    assert work.hit_i.shape == (k * n,) and work.hit_j.shape == (k * n,)
    assert work.hit_i.dtype == work.hit_j.dtype == work.tap_off.dtype == torch.int32
    np.testing.assert_array_equal(work.tap_off.numpy(), off)
    np.testing.assert_array_equal(work.hit_i[:off[-1]].numpy(), hi)
    np.testing.assert_array_equal(work.hit_j[:off[-1]].numpy(), hj)
    return work


@pytest.mark.parametrize("k, n, density", [(27, 500, 0.1), (8, 333, 0.5),
                                           (3, 64, 1.0), (1, 1, 1.0)])
def test_work_list_matches_a_brute_force_build(k, n, density):
    check_list(random_map(k, n, 400, density, seed=k * n))


def test_work_list_of_a_map_with_an_all_miss_tap():
    bwd = random_map(27, 300, 300, 0.2, seed=1)
    bwd[0] = -1
    bwd[13] = -1
    bwd[26] = -1
    work = check_list(bwd)
    off = work.tap_off.numpy()
    assert off[1] == off[0] == 0 and off[14] == off[13] and off[27] == off[26]


def test_work_list_of_an_empty_plan():
    work = check_list(np.full((27, 50), -1, np.int32))
    assert not work.tap_off.any()
    empty = kernels.wgrad_work_list(torch.zeros((8, 0), dtype=torch.int32))
    assert empty.hit_i.numel() == 0 and empty.tap_off.tolist() == [0] * 9


def items_of(tap_off: np.ndarray, per_item: int):
    """The kernel's items (tap, first hit, end) in blockIdx order: tap k's
    hits cut into ceil(hits_k / H) items of at most H."""
    out = []
    for kk in range(len(tap_off) - 1):
        for h0 in range(tap_off[kk], tap_off[kk + 1], per_item):
            out.append((kk, h0, min(h0 + per_item, tap_off[kk + 1])))
    return out


def wgrad_by_items(feats, g, bwd, per_item):
    """gather_wgrad's algorithm on the CPU: one partial tile per item (the
    kernel keeps it in float64), then each tap's items summed in index
    order in float64."""
    work = kernels.wgrad_work_list(bwd)
    k, n = bwd.shape
    m = g.shape[0]
    items = items_of(work.tap_off.numpy(), per_item)
    assert len(items) <= -(-k * n // per_item) + k       # the scratch bound
    partial = []
    for _, h0, h1 in items:
        i = work.hit_i[h0:h1].long()
        j = work.hit_j[h0:h1].long()
        gj = torch.where((j < m)[:, None], g[j.clamp(max=m - 1)],
                         torch.zeros(()))
        partial.append((feats[i].T @ gj).double())
    dw = torch.zeros((k, feats.shape[1], g.shape[1]), dtype=torch.float64)
    for (kk, _, _), p in zip(items, partial):
        dw[kk] += p
    return dw.float(), items


@pytest.mark.parametrize("n, per_item", [(1000, 64), (1000, 1024),
                                         (777, 100), (64, 2048)])
def test_items_cover_each_tap_once_and_sum_to_the_twin(n, per_item):
    """N not a multiple of H: the last item of a tap is short, no item
    crosses a tap, and the items' sums equal the plain twin's."""
    bwd_np = random_map(27, n, 600, 0.3, seed=n + per_item)
    bwd_np[5] = -1                                     # a tap with no item
    bwd = torch.from_numpy(bwd_np)
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((600, 8)).astype(np.float32))
    got, items = wgrad_by_items(feats, g, bwd, per_item)
    want = kernels.gather_wgrad_plain(feats, g, bwd)
    # summed in another order: held to the kernels' float32 bound
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    counts = (bwd_np >= 0).sum(1)
    for kk in range(27):
        mine = [(h0, h1) for t, h0, h1 in items if t == kk]
        assert len(mine) == -(-counts[kk] // per_item)
        assert sum(h1 - h0 for h0, h1 in mine) == counts[kk]
        assert all(h1 - h0 <= per_item for h0, h1 in mine)


def _scan(n=300, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.unique(rng.integers(0, 24, size=(n, 3)), axis=0)
    order = np.lexsort((xyz[:, 0], xyz[:, 1], xyz[:, 2]))
    coords = np.concatenate([xyz[order], np.zeros((len(xyz), 1), int)], 1)
    cap = 512
    pad = np.full((cap, 4), C.INVALID_COORD, np.int32)
    pad[:len(coords)] = coords
    feats = rng.standard_normal((cap, 8)).astype(np.float32)
    return make_sparse_tensor(feats, pad, nnz=len(coords), base_sorted=True,
                              device="cpu")


@pytest.fixture
def builds(monkeypatch):
    """Counts the calls of `kernels.wgrad_work_list` (on the CPU its
    `builds` counter stays 0: it counts builds on the card only)."""
    calls = []
    real = kernels.wgrad_work_list

    def counted(bwd_idx):
        calls.append(bwd_idx)
        return real(bwd_idx)

    monkeypatch.setattr(kernels, "wgrad_work_list", counted)
    return calls


def test_a_plan_builds_its_work_lists_once(builds):
    st = _scan()
    plan = tconv.build_conv_plan(st.coords, st.coords, st.nnz,
                                 C.kernel_offsets_np(3), st.capacity,
                                 in_sorted=True)
    kernels.reset_launch_counts()
    work = tconv.plan_wgrad_work(plan)
    assert tconv.plan_wgrad_work(plan) is work and plan.bwd_work is work
    assert len(builds) == 1
    assert kernels.wgrad_work_list.builds == 0       # the twin ran
    hi, hj, off = brute_force(tconv.plan_bwd_idx(plan).numpy())
    np.testing.assert_array_equal(work.tap_off.numpy(), off)
    np.testing.assert_array_equal(work.hit_i[:off[-1]].numpy(), hi)
    # the transposed conv's list is over in_idx, kept apart
    t_work = tconv.plan_wgrad_work(plan, transposed=True)
    assert t_work is not work and plan.in_work is t_work
    assert tconv.plan_wgrad_work(plan, transposed=True) is t_work
    assert len(builds) == 2 and builds[1] is plan.in_idx


def test_convs_sharing_a_plan_reuse_its_work_list(builds):
    """Two convs on one plan (forward and backward through GatherConv)
    build one list; the weight gradients match autograd through the twin."""
    st = _scan(seed=3)
    w1 = torch.randn((27, 8, 8), generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    w2 = torch.randn((27, 8, 8), generator=torch.Generator().manual_seed(1),
                     requires_grad=True)
    x = tconv.conv3d(st, w1, 3)
    y = tconv.conv3d(x, w2, 3)
    assert len(builds) == 1
    plan = st.kmaps[("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))]
    assert plan.bwd_work is not None
    (y.feats ** 2).sum().backward()
    assert len(builds) == 1
    want = []
    for w in (w1, w2):
        want.append(w.grad.clone())
        w.grad = None
    idx = plan.in_idx
    x2 = kernels.gather_conv_plain(st.feats, idx, w1)
    y2 = kernels.gather_conv_plain(x2, idx, w2)
    (y2 ** 2).sum().backward()
    torch.testing.assert_close(want[0], w1.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(want[1], w2.grad, rtol=1e-5, atol=1e-4)
