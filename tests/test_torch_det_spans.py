"""The detector's layer spans on the CPU, under torch.profiler: a tiny
VoxelNet training step (`det_train_step`, grid (48, 48, 40), two made
frames with targets).

- `bev/forward` and `loss/forward` lie in the trainer's forward range,
  `bev/backward` and `loss/backward` in its backward range, one each; the
  head's maps' backward (the convolution backward of the neck and head)
  inside `bev/backward`, the loss's own backward inside `loss/backward`,
  and the backbone's sparse conv ranges outside `bev/*`;
- no operation lies in two of `conv/*`, `sparse/plan` and `loss/*`;
- with no profiler, the step enters no range and the graph gains no
  node;
- `perfbench/metrics/bev.device_ms.py` reads the merged `bev/*` spans.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.data.nuscenes import SyntheticNuScenes
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models.voxelnet import VoxelNet
from link_tpu_torch.train import det_trainer as DT
from link_tpu_torch.utils import profiling as P
from perfbench import harness
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROLES = (P.CONV_FWD, P.CONV_DGRAD, P.CONV_WGRAD)


@pytest.fixture(scope="module")
def det():
    ds = SyntheticNuScenes(length=2, mode="train", n_points=3000,
                           pc_range=(-12, -12, -2, 12, 12, 2),
                           voxel_size=(0.5, 0.5, 0.1), max_voxels=4000)
    batch = dp.collate_det([ds[0], ds[1]], 2 * 4096)
    model = VoxelNet(batch_size=2, grid_shape=(48, 48, 40),
                     capacities=det_capacities(4096, 2), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    opt = DT.make_one_cycle_adam(model, lambda c: 1e-3, lambda c: 0.85)
    return model, opt, batch


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


def _within(inner, outer) -> bool:
    return inner[3] == outer[3] and outer[1] <= inner[1] < outer[2]


def test_bev_and_loss_spans_in_a_det_train_step(det):
    model, opt, batch = det
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        DT.det_train_step(model, opt, batch)
    ev = _events(prof)

    def one(name):
        got = [e for e in ev if e[0] == name]
        assert len(got) == 1, (name, len(got))
        return got[0]

    fwd, bwd = one(DT.RANGES[0]), one(DT.RANGES[1])
    bev_f, bev_b = one(P.BEV_FWD), one(P.BEV_BWD)
    loss_f, loss_b = one(P.LOSS_FWD), one(P.LOSS_BWD)
    assert _within(bev_f, fwd) and _within(loss_f, fwd)
    assert bev_f[2] <= loss_f[1]
    # the backward ranges on the thread that runs the backward, the
    # loss's first, then the head's and the neck's
    assert loss_b[1] >= bwd[1] and loss_b[2] <= bev_b[1] <= bev_b[2]
    assert any(_within(e, bev_b) for e in ev
               if e[0] == "aten::convolution_backward")
    assert not any(_within(e, bev_b) for e in ev if e[0] in ROLES)
    assert any(_within(e, loss_b) for e in ev
               if e[0] == "aten::sigmoid_backward")
    spans = [e for e in ev if e[0] in ROLES + (P.PLAN, P.LOSS_FWD,
                                                 P.LOSS_BWD)]
    for op in (e for e in ev if e[0].startswith("aten::")):
        holders = {"loss" if s[0].startswith("loss/") else s[0]
                   for s in spans if _within(op, s)}
        assert len(holders) <= 1, (op, holders)


def test_det_spans_cost_nothing_without_a_profiler(det, monkeypatch):
    model, opt, batch = det
    entered = []
    real = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: entered.append(a[0]) or real(*a))
    DT.det_train_step(model, opt, batch)
    # torch.optim enters its own ranges whatever the profiler's state
    assert [n for n in entered if not n.startswith("Optimizer.")] == []
    inputs = dp.det_inputs(batch, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced = model(*inputs)
    plain = model(*inputs)
    # the maps are the same; under a profiler the graph gains a view of
    # the BEV map (it closes `bev/backward`) and one of each of the four
    # ELK blocks' inputs, and without one nothing
    for a, b in zip(traced, plain):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert _nodes(traced) == _nodes(plain) + 1 + 4


def _nodes(preds) -> int:
    seen = set()
    todo = [v.grad_fn for d in preds for v in d.values()]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return len(seen)


def test_bev_reader_reads_the_merged_spans():
    reader = harness.metric_reader("bev.device_ms.train")
    red = {"ranges": [(0, 100, "bev/forward"), (200, 300, "bev/backward"),
                      (250, 260, "conv/dgrad")],
           "ops": [(10, 0.001, "k"), (210, 0.002, "k"), (150, 0.5, "k"),
                   (None, 0.7, "k")]}
    run = types.SimpleNamespace(red=red, info={"samples_traced": 2})
    assert reader.read(run) == pytest.approx(1.5)
    run.red = dict(red, ranges=[])
    assert reader.read(run) is None
    run.red = None
    assert reader.read(run) is None
    assert np.isfinite(reader.read(types.SimpleNamespace(
        red=red, info={"samples_traced": 6})))
