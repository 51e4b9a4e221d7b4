"""The port's layer spans (`link_tpu_torch/utils/profiling.py`) on the CPU,
under torch.profiler, and the benchmark readers that read them.

- a tiny `GatherConv` and `WindowConv` forward and backward: each kernel
  twin's call lies in the `conv/*` range of its role, and no operation in
  two of the conv and plan ranges;
- a tiny `ELKBlock` beside a sibling conv branch, summed as
  `linkunet.encode` does, plain and rematerialized: the block's
  `index_add_` / `index_select` backward ops (and the replay) lie inside
  `elk/backward`, the sibling's convs' backward outside it;
- a tiny ELKUNet training step: every join site inside `sparse/plan`, no
  conv range inside or around a plan range, the loss in `loss/*`, and no
  operation in two of the conv, plan and loss ranges;
- with no profiler, no `record_function` entry and no marker node;
- the seven per-layer readers of `perfbench/metrics/` on a synthetic
  reduced trace.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models.elk import ELKBlock
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.nn import remat
from link_tpu_torch.nn.modules import SparseConv3d
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.tensor import make_sparse_tensor
from link_tpu_torch.train import trainer as T
from link_tpu_torch.utils import profiling as P
from perfbench import harness
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROLES = (P.CONV_FWD, P.CONV_DGRAD, P.CONV_WGRAD)
CAPS = (384, 192, 96, 48, 24)


def _coords(seed=0, cap=512):
    """~300 unique voxels of a 12^3 grid in pack-key order, padded to
    `cap` with the sentinel."""
    rng = np.random.default_rng(seed)
    xyz = np.unique(rng.integers(0, 12, (300, 3)), axis=0)
    xyz = xyz[np.lexsort((xyz[:, 0], xyz[:, 1], xyz[:, 2]))]
    n = len(xyz)
    c = np.full((cap, 4), C.INVALID_COORD, np.int32)
    c[:n, :3] = xyz
    c[:n, 3] = 0
    return torch.from_numpy(c), n


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


def _within(inner, outer) -> bool:
    """`inner` starts inside `outer`, on its thread."""
    return inner[3] == outer[3] and outer[1] <= inner[1] < outer[2]


def _named(name, fn):
    def call(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return call


def _in_one_at_most(ev, names):
    """Every aten operation lies inside spans of at most one of `names`."""
    spans = [e for e in ev if e[0] in names]
    for op in (e for e in ev if e[0].startswith("aten::")):
        holders = {s[0] for s in spans if _within(op, s)}
        assert len(holders) <= 1, (op, holders)


@pytest.mark.parametrize("form", ["gather", "window"])
def test_conv_twins_run_in_the_range_of_their_role(form, monkeypatch):
    coords, n = _coords()
    cap = coords.shape[0]
    offs = C.kernel_offsets_np(3)
    table = C.build_table(coords, assume_sorted=True)
    plan = tconv.build_conv_plan(coords, coords, torch.tensor(n), offs, cap,
                                 in_sorted=True, table=table)
    if form == "window":
        plan = tconv.add_window_form(plan, table, offs, 1)
    for name in ("gather_conv", "window_conv", "gather_wgrad"):
        monkeypatch.setattr(kernels, name,
                            _named(f"twin/{name}", getattr(kernels, name)))
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(cap, 8, generator=gen).requires_grad_()
    w = (torch.randn(27, 8, 8, generator=gen) * 0.1).requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test/forward"):
            out = tconv.apply_conv_plan(feats, w, plan,
                                        prefer_window=form == "window")
        with record_function("test/backward"):
            out.square().sum().backward()
    ev = _events(prof)
    fwd = next(e for e in ev if e[0] == "test/forward")
    roles = [e for e in ev if e[0] in ROLES]
    twins = [e for e in ev if e[0].startswith("twin/")]
    conv = f"twin/{form}_conv"
    assert sorted(t[0] for t in twins) == sorted(
        [conv, conv, "twin/gather_wgrad"])
    got = []
    for t in twins:
        want = (P.CONV_WGRAD if t[0] == "twin/gather_wgrad" else
                P.CONV_FWD if _within(t, fwd) else P.CONV_DGRAD)
        assert [r[0] for r in roles if _within(t, r)] == [want]
        got.append(want)
    assert sorted(got) == sorted(ROLES)
    # each twin's operations lie in its role's range, and no operation in
    # two of the conv and plan ranges
    ops = [e for e in ev if e[0].startswith("aten::")
           and any(_within(e, t) for t in twins)]
    assert ops and all(any(_within(o, r) for r in roles) for o in ops)
    _in_one_at_most(ev, ROLES + (P.PLAN,))


@pytest.mark.parametrize("rematerialized", [False, True])
def test_elk_backward_range_holds_the_block_and_not_its_sibling(
        rematerialized):
    coords, n = _coords(1)
    cap = coords.shape[0]
    gen = torch.Generator().manual_seed(1)
    stem = SparseConv3d(4, 8, 3, device="cpu", generator=gen)
    sibling = SparseConv3d(8, 8, 3, device="cpu", generator=gen)
    elk = ELKBlock(8, aux_capacity=cap, device="cpu", generator=gen)
    tail = SparseConv3d(8, 8, 3, device="cpu", generator=gen)
    if rematerialized:
        elk.remat_policy = remat.PLANS_AND_CONV_OUTPUTS
    feats = torch.zeros(cap, 4)
    feats[:n] = torch.randn(n, 4, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = make_sparse_tensor(feats, coords, nnz=n, device="cpu")
        st0 = stem(st)
        y = sibling(st0)
        lk = tail(elk(st0, 3, 2))
        out = torch.relu(y.feats + lk.feats)
        with record_function("test/backward"):
            out.square().sum().backward()
    ev = _events(prof)
    bwd = next(e for e in ev if e[0] == "test/backward")
    elk_b = [e for e in ev if e[0] == P.ELK_BWD]
    assert len(elk_b) == 1 and _within(elk_b[0], bwd)
    elk_b = elk_b[0]
    in_bwd = [e for e in ev if _within(e, bwd)]
    adds = [e for e in in_bwd if e[0] == "aten::index_add_"]
    picks = [e for e in in_bwd if e[0] == "aten::index_select"]
    assert adds and picks
    assert all(_within(e, elk_b) for e in adds + picks)
    # the block's local conv inside, the sibling's, the stem's and the
    # tail's outside (the stem's input needs no gradient: no dgrad)
    for role, total in ((P.CONV_WGRAD, 4), (P.CONV_DGRAD, 3)):
        spans = [e for e in in_bwd if e[0] == role]
        assert len(spans) == total
        assert sum(_within(e, elk_b) for e in spans) == 1
    # the replay of a rematerialized block (its LayerNorms' forward) runs
    # inside the range
    norms = [e for e in in_bwd if e[0] == "aten::rsqrt"]
    assert bool(norms) == rematerialized
    assert all(_within(e, elk_b) for e in norms)
    elk_f = [e for e in ev if e[0] == P.ELK_FWD]
    assert len(elk_f) == 1
    assert any(_within(e, elk_f[0]) for e in ev if e[0] == P.PLAN)


@pytest.fixture(scope="module")
def seg():
    """A tiny ELKUNet, its optimizer and a collated batch of two scans."""
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=11)
    batch = collate_scans([ds[0], ds[1]], CAPS[0])
    model = ELKUNet(20, cr=0.125, capacities=CAPS, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return model, T.make_sgd(model.parameters(), 0.01), batch


def test_plan_holds_the_joins_and_no_conv_in_a_train_step(seg):
    model, opt, batch = seg
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.seg_train_step(model, opt, batch)
    ev = _events(prof)
    plans = [e for e in ev if e[0] == P.PLAN]
    joins = [e for e in ev if e[0] == C.JOIN_RANGE]
    convs = [e for e in ev if e[0] in ROLES]
    assert plans and joins and convs
    assert all(any(_within(j, p) for p in plans) for j in joins)
    assert not any(_within(c, p) or _within(p, c) for c in convs
                   for p in plans)
    loss_f = [e for e in ev if e[0] == P.LOSS_FWD]
    loss_b = [e for e in ev if e[0] == P.LOSS_BWD]
    fwd = next(e for e in ev if e[0] == T.RANGES[0])
    bwd = next(e for e in ev if e[0] == T.RANGES[1])
    assert len(loss_f) == len(loss_b) == 1
    assert _within(loss_f[0], fwd) and _within(loss_b[0], bwd)
    assert any(_within(e, loss_b[0]) for e in ev
               if e[0] == "aten::_log_softmax_backward_data")
    # the ELK blocks' backward ranges come after the loss's
    elk_b = [e for e in ev if e[0] == P.ELK_BWD]
    assert len(elk_b) == 4 and all(e[1] >= loss_b[0][2] for e in elk_b)
    _in_one_at_most(ev, ROLES + (P.PLAN, P.LOSS_FWD, P.LOSS_BWD))


def _nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return len(seen)


def test_spans_cost_nothing_without_a_profiler(seg, monkeypatch):
    model, opt, batch = seg
    entered = []
    real = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: entered.append(a[0]) or real(*a))
    assert P.span("x/y") is P.span("z/w")
    T.seg_train_step(model, opt, batch)
    # torch.optim enters its own ranges whatever the profiler's state
    assert [n for n in entered if not n.startswith("Optimizer.")] == []
    # the block adds no node to the graph; under a profiler, one view of
    # its input
    st, _, _ = T._batch_on(model, batch)
    st0 = model.down1(model.stem(st))
    elk = model.elk1
    plain = _nodes(elk._block(st0, 2 * model.s, model.r).feats)
    assert _nodes(elk(st0, 2 * model.s, model.r).feats) == plain
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _nodes(elk(st0, 2 * model.s, model.r).feats)
    assert traced == plain + 1 and P.ELK_FWD in entered


def _red():
    """A reduced trace (`perfbench/trace.reduce`'s `ranges` and `ops`):
    spans on two threads, nested and overlapping, and ops at launch times
    (ns) with their device seconds."""
    ranges = [(0, 100, "elk/forward"), (10, 40, "conv/fwd"),
              (20, 30, "conv/fwd"), (50, 60, "sparse/plan"),
              (52, 58, "sparse/join_site"), (200, 300, "elk/backward"),
              (210, 250, "conv/dgrad"), (240, 280, "conv/wgrad"),
              (400, 420, "loss/forward"), (150, 190, "loss/backward"),
              (0, 500, "seg_train/forward")]
    ops = [(12, 0.001, "gather_conv"), (25, 0.002, "gather_conv"),
           (40, 0.004, "relu"), (55, 0.008, "sorted_join"),
           (215, 0.016, "gather_conv"), (245, 0.032, "gather_wgrad"),
           (260, 0.064, "wgrad_reduce"), (410, 0.128, "log_softmax"),
           (160, 0.256, "nll_backward"), (None, 1.0, "no launch"),
           (600, 2.0, "outside")]
    return {"ranges": ranges, "ops": ops}


@pytest.mark.parametrize("name,want", [
    ("conv.fwd_device_ms.train", (0.001 + 0.002) * 1e3 / 2),
    ("conv.dgrad_device_ms.train", (0.016 + 0.032) * 1e3 / 2),
    ("conv.wgrad_device_ms.train", (0.032 + 0.064) * 1e3 / 2),
    ("conv.range_roofline.train", 0.0119 / (0.001 + 0.002 + 0.016 + 0.032
                                             + 0.064) * 100.0),
    ("plan.device_ms.train", 0.008 * 1e3 / 2),
    ("elk.device_ms.train", (0.001 + 0.002 + 0.004 + 0.008 + 0.016 + 0.032
                             + 0.064) * 1e3 / 2),
    ("loss.device_ms.train", (0.128 + 0.256) * 1e3 / 2)])
def test_span_readers_on_a_synthetic_trace(name, want):
    reader = harness.metric_reader(name)
    info = {"samples_traced": 2, "traced_conv_least_s": 0.0119}
    run = types.SimpleNamespace(red=_red(), info=info)
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    # a trace without the spans (a program without them), and no trace
    bare = {"ranges": [r for r in _red()["ranges"]
                       if r[2].startswith("seg_train/")], "ops": _red()["ops"]}
    assert reader.read(types.SimpleNamespace(red=bare, info=info)) is None
    assert reader.read(types.SimpleNamespace(red=None, info=info)) is None
    entry = {m["name"]: m for m in harness.benchmark()["per_layer"]}[name]
    assert entry["source"] == "device_trace"
    assert entry["moves"] == "train_samples_per_s"
    assert entry["workloads"] == ["seg_train.linkunet.b2"]
