"""Rematerialized seg training (`remat=True`, `nn/remat.py`) against the
same step without it, on the CPU.

ELKUNet, ELKEncoder and MinkUNet at the size of
tests/test_torch_train_step.py (cr 0.125, capacities (384, 192, 96, 48,
24), a batch of two synthetic scans of seed 11), each built twice from the
same seed, once with `remat=True`. The JAX package holds its remat models
equal to its plain ones in tests/test_remat_policy.py (slow-marked); the
port's remat ELKUNet step against the JAX step is in
tests/test_torch_train_step.py, which reuses its one jitted step.

What is held, for one SGD step from the same weights on the same batch:
  * the loss, every parameter's gradient and every BatchNorm buffer equal
    to the bit (on the CPU every sum runs in one fixed order, so the
    replay recomputes the forward's values exactly; the bound of 1e-6
    relative is met with nothing to spare); ELKUNet and ELKEncoder also in
    bfloat16 and through the dense aux grid (a grid extent);
  * the replay ran (the BatchNorms ran more often) and launched no conv
    and no join (`gather_conv`, `sorted_join`, `gather_wgrad` called as
    often as without remat), but under MinkUNet's policy, which keeps the
    plans only (the JAX MinkUNet's `_plan_policy`): its replay runs the 36
    convs of its blocks again;
  * the running statistics moved once: a replay that moves them again (a
    planted fault) breaks the equality;
  * with a 1-rank gloo process group as SyncBN group, the step makes the
    same number of all-reduce calls with remat as without, and its
    results are equal; on 2 gloo ranks, `dp_check`'s SyncBN remat job
    holds (the card's `dp_train` runs it at full size);
  * `make_model(remat=True)`, `seg_train` and `profile_fwd --train` build
    the rematerialized model, SPVCNN without remat, as the JAX builder.
"""

import functools
import os

import pytest
import torch

from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import (SyntheticSemanticKITTI,
                                                grid_extent)
from link_tpu_torch.models import builder
from link_tpu_torch.models.blocks import BasicConvolutionBlock, ResidualBlock
from link_tpu_torch.models.elk import ELKBlock
from link_tpu_torch.models.linkencoder import ELKEncoder
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.nn import remat
from link_tpu_torch.nn.modules import SparseBatchNorm, sync_batch_norms
from link_tpu_torch.ops import kernels
from link_tpu_torch.tools import dp_check, profile_fwd, seg_train
from link_tpu_torch.train import trainer as T
from link_tpu_torch.utils.config import load_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = (384, 192, 96, 48, 24)
CR = 0.125
VOXEL = 0.4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"ELKUNet": ELKUNet, "ELKEncoder": ELKEncoder, "MinkUNet": MinkUNet}
KERNELS = ("gather_conv", "sorted_join", "gather_wgrad")
# MinkUNet's blocks hold 36 K > 1 convs: 4 downs, 16 residual blocks of 2
MINKUNET_REPLAYED_CONVS = 36


def _batch(ext=None):
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=VOXEL,
                                split="train", seed=11)
    return collate_scans([ds[0], ds[1]], CAPS[0], grid_extent=ext)


@pytest.fixture(scope="module")
def batches():
    ext = grid_extent(VOXEL, batch_size=2)
    return {None: _batch(), ext: _batch(ext)}


@pytest.fixture
def calls(monkeypatch):
    """Calls of the kernels' wrappers ({name: n}) and of the BatchNorms'
    forward (under "bn")."""
    out = dict.fromkeys(KERNELS + ("bn",), 0)
    for name in KERNELS:
        real = getattr(kernels, name)

        def spy(*a, _real=real, _name=name, **kw):
            out[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kernels, name, spy)
    real_bn = SparseBatchNorm.forward

    def bn(self, st):
        out["bn"] += 1
        return real_bn(self, st)
    monkeypatch.setattr(SparseBatchNorm, "forward", bn)
    return out


def _step(name, remat_on, batch, calls=None, dtype="float32", ext=None,
          group=None):
    """One SGD step (lr 0.01) of the seed-0 model: (metrics, gradients,
    BatchNorm buffers, model, the wrappers' and BatchNorms' calls)."""
    kw = dict(grid_extent=ext) if name != "MinkUNet" else {}
    model = MODELS[name](20, cr=CR, capacities=CAPS, dtype=dtype,
                         remat=remat_on, device="cpu",
                         generator=torch.Generator().manual_seed(0), **kw)
    sync_batch_norms(model, group)
    opt = T.make_sgd(model.parameters(), 0.01)
    if calls is not None:
        for k in calls:
            calls[k] = 0
    metrics = T.seg_train_step(model, opt, batch, group=group)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    bufs = {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k or "num_batches" in k}
    return metrics, grads, bufs, model, dict(calls or {})


def _equal(a, b):
    """The names of the entries of two {name: tensor} dicts that differ."""
    assert sorted(a) == sorted(b)
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("name,dtype,dense_aux", [
    ("ELKUNet", "float32", False), ("ELKUNet", "bfloat16", True),
    ("ELKEncoder", "float32", False), ("ELKEncoder", "bfloat16", True),
    ("MinkUNet", "float32", False), ("MinkUNet", "bfloat16", False)])
def test_remat_step_equals_the_plain_step(batches, calls, name, dtype,
                                          dense_aux):
    ext = next(e for e in batches if e is not None) if dense_aux else None
    b = batches[ext]
    m0, g0, s0, _, c0 = _step(name, False, b, calls, dtype, ext)
    m1, g1, s1, model, c1 = _step(name, True, b, calls, dtype, ext)
    assert all(float(m0[k]) == float(m1[k]) for k in m0), (m0, m1)
    assert not _equal(g0, g1)
    assert not _equal(s0, s1)
    assert all(int(m.num_batches_tracked) == 1 for m in model.modules()
               if isinstance(m, SparseBatchNorm))
    assert c1["bn"] > c0["bn"]                 # the blocks were replayed
    extra = MINKUNET_REPLAYED_CONVS if name == "MinkUNet" else 0
    assert c1 == {**c0, "bn": c1["bn"],
                  "gather_conv": c0["gather_conv"] + extra}, (c0, c1)


def test_planted_double_statistics_update_is_caught(batches, monkeypatch):
    b = batches[None]
    _, _, s0, _, _ = _step("ELKUNet", False, b)
    monkeypatch.setattr(remat, "replaying", lambda: False)
    _, _, s1, model, _ = _step("ELKUNet", True, b)
    assert _equal(s0, s1)
    assert any(int(m.num_batches_tracked) == 2 for m in model.modules()
               if isinstance(m, SparseBatchNorm))


def test_syncbn_remat_makes_the_same_collective_calls(batches, monkeypatch,
                                                      tmp_path):
    dist = torch.distributed
    count = {"n": 0}
    real = dist.all_reduce

    def all_reduce(*a, **kw):
        count["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        group = dist.new_group([0])
        out = []
        for remat_on in (False, True):
            count["n"] = 0
            m, g, s, model, _ = _step("ELKUNet", remat_on, batches[None],
                                      group=group)
            out.append((m, g, s, count["n"]))
    finally:
        dist.destroy_process_group()
    (m0, g0, s0, n0), (m1, g1, s1, n1) = out
    bns = sum(isinstance(m, SparseBatchNorm) for m in model.modules())
    # each SyncBN's sum and its gradient's, and the step's one all-reduce
    assert n0 == n1 == 2 * bns + 1, (n0, n1, bns)
    assert all(float(m0[k]) == float(m1[k]) for k in m0)
    assert not _equal(g0, g1) and not _equal(s0, s1)


def test_two_rank_syncbn_remat_step_holds(tmp_path):
    """dp_check's SyncBN remat job (the card's `dp_train` runs it at full
    size) on 2 gloo ranks of the CPU: the remat step equal to the plain
    one, the same all-reduce calls and launches on every rank, nothing
    failed."""
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=VOXEL,
                                split="train", seed=11)
    job = {"name": "seg_syncbn_remat", "remat_runs": True, "step": "seg",
           "seed": 0,
           "model": functools.partial(ELKUNet, 20, cr=CR, capacities=CAPS),
           "optimizer": functools.partial(dp_check.sgd, lr=0.01),
           "step_kwargs": {"ignore_label": 0, "lr": 0.01},
           "batches": [collate_scans([ds[r]], CAPS[0]) for r in range(2)]}
    ranks = dp_check.run_ranks([job], 2, "gloo", "cpu", str(tmp_path))
    res = dp_check.hold_remat(job, ranks, str(tmp_path))
    assert res["failed"] == [], res
    assert res["loss_err"] == 0.0 and res["stats"][0] == 0.0
    assert res["grad"][0] == 0.0
    bns = sum(isinstance(m, SparseBatchNorm) for m in ELKUNet(
        20, cr=CR, capacities=CAPS, device="cpu").modules())
    runs = len(dp_check.REMAT_RUNS)
    assert res["all_reduce_calls"] == [[2 * bns + 1] * runs] * 2


def _readings(grads, loss=2.0, stat=1.0):
    return {"metrics": {"loss": loss, "loss_ce": loss / 2},
            "grads": {k: g.clone() for k, g in grads.items()},
            "stats": {"bn.running_mean": torch.full((4,), stat)}}


@pytest.mark.parametrize("fault,failed", [
    (None, []),
    ("loss", ["loss"]),
    ("stats", ["stats"]),
    ("gradient", ["gradients"]),
])
def test_remat_holds_reads_each_planted_fault(fault, failed):
    """`dp_check.remat_holds`, which the card's remat_train and dp_train
    share: a remat step equal to the plain one holds; a loss or a running
    statistic off by 1e-4 relative, or a gradient scaled by 1.01 (the
    plain repeats equal to the bit, so the limits are the floor), is read
    outside; the sum for the mean always reads outside."""
    gen = torch.Generator().manual_seed(0)
    grads = {f"w{i}": torch.randn(8, 8, generator=gen) for i in range(3)}
    runs = {run: _readings(grads) for run in dp_check.REMAT_RUNS}
    if fault == "loss":
        runs["remat"] = _readings(grads, loss=2.0 * (1 + 1e-4))
    elif fault == "stats":
        runs["remat"] = _readings(grads, stat=1.0 + 1e-4)
    elif fault == "gradient":
        runs["remat"] = _readings({k: 1.01 * g for k, g in grads.items()})
    out = dp_check.remat_holds(runs)
    assert out["failed"] == failed, out
    assert dp_check._worst_share(out["control"]) > 1.0


def test_remat_keeps_the_state_dict_and_the_inference_path(batches):
    plain = ELKUNet(20, cr=CR, capacities=CAPS, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    re = ELKUNet(20, cr=CR, capacities=CAPS, remat=True, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    assert _equal(plain.state_dict(), re.state_dict()) == []
    wrapped = [type(m) for m in re.modules()
               if getattr(m, "remat_policy", None)]
    # 4 downs, 8 stage and 8 decoder residual blocks, 4 ELK blocks
    assert len(wrapped) == 24
    assert {t: wrapped.count(t) for t in set(wrapped)} == {
        BasicConvolutionBlock: 4, ResidualBlock: 16, ELKBlock: 4}
    b = batches[None]
    outs = []
    for model in (plain, re):
        model.eval()
        st, _, _ = T._batch_on(model, b)
        with torch.inference_mode():
            outs.append(model(st))
    assert torch.equal(*outs)


@pytest.mark.parametrize("family,policy", [
    ("linkunet", remat.PLANS_AND_CONV_OUTPUTS),
    ("linkencoder", remat.PLANS_AND_CONV_OUTPUTS),
    ("minkunet", remat.PLANS), ("spvcnn", None)])
def test_make_model_passes_remat(family, policy):
    cfg = load_config(os.path.join(REPO, "configs", "semantic_kitti",
                                   family, "default.yaml"))
    cfg.model.cr = CR
    model = builder.make_model(cfg, capacities=CAPS, device="cpu",
                               remat=True)
    got = {getattr(m, "remat_policy", None) for m in model.modules()} - {
        None}
    assert got == ({policy} if policy else set())


class _Built(Exception):
    """Raised by a spy with the model the tool built."""


def test_seg_train_and_profile_fwd_build_with_remat(monkeypatch, tmp_path):
    real = builder.make_model

    def spy(*a, **kw):
        raise _Built(real(*a, **kw))
    monkeypatch.setattr(builder, "make_model", spy)
    config = os.path.join(REPO, "configs", "semantic_kitti", "linkunet",
                          "default.yaml")
    with pytest.raises(_Built) as built:
        seg_train.main([config, "--synthetic", "--device", "cpu",
                        "--run-dir", str(tmp_path / "run"),
                        "model.capacities=[384,192,96,48,24]",
                        f"model.cr={CR}", "dataset.num_points=300",
                        f"dataset.voxel_size={VOXEL}",
                        "dataset.synthetic_length=2"])
    assert any(getattr(m, "remat_policy", None) for m in
               built.value.args[0].modules())

    for k, v in dict(SEG_CAPS=CAPS, SEG_CR=CR, SEG_VOXELS=300,
                     SEG_RAW_POINTS=3000, SEG_VOXEL_SIZE=VOXEL).items():
        monkeypatch.setattr(profile_fwd, k, v)
    real_model = profile_fwd.seg_model

    def seg_model(*a, **kw):
        raise _Built(real_model(*a, **kw))
    monkeypatch.setattr(profile_fwd, "seg_model", seg_model)
    for train in (False, True):
        with pytest.raises(_Built) as built:
            profile_fwd.seg_call(profile_fwd.parse_args(
                ["--device", "cpu"] + (["--train"] if train else [])), "cpu")
        assert any(getattr(m, "remat_policy", None) for m in
                   built.value.args[0].modules()) is train
