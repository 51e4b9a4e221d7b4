"""The port's data-parallel seg train step on 2 gloo processes against the
JAX package's `make_dp_train_step` on 2 CPU devices.

A small ELKUNet (cr 0.125, the capacities (512, 256, 128, 64, 32) of
tests/test_train.py) from the port's seed-0 init, carried to the JAX trees
by `translate_elkunet`; one synthetic scan per replica, made with numpy;
SGD (nesterov, momentum 0.9, coupled decay 1e-4) at lr 0.05. The port's
ranks are spawned by `link_tpu_torch.tools.dp_check.run_ranks` (the module
imports no JAX), join through a file, and run the step with
`group=WORLD`; rank 0 hands back its loss, gradients, parameters and
running statistics. One jitted JAX train step (its optimizer wrapped to
hand back the averaged gradients) and one jitted eval step.

Bounds (float32 on both sides, sums in another order): the loss terms
1e-4 absolute; each gradient leaf 1e-3 of its largest magnitude and each
parameter after the step 1e-3 of its leaf's (tests/test_torch_train_step.py
explains the width); the running statistics 1e-5 of their largest
magnitude; the eval counters (summed over the replicas) exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.models.linkunet import ELKUNet as JELKUNet
from link_tpu.train import trainer as JT
from link_tpu.utils.torch_import import translate_elkunet
from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.parallel import sequential_dp_step
from link_tpu_torch.tools import dp_check
from link_tpu_torch.train import trainer as TT
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_family import _capturing, flat

CAPS = (512, 256, 128, 64, 32)
CR = 0.125
LR = 0.05
NUM_CLASSES = 20


def _batches():
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=11)
    return [collate_scans([ds[r]], CAPS[0]) for r in range(2)]


def _job(batches):
    return {"name": "seg", "step": "seg", "seed": 0,
            "model": functools.partial(ELKUNet, NUM_CLASSES, cr=CR,
                                       capacities=CAPS),
            "optimizer": functools.partial(dp_check.sgd, lr=LR),
            "step_kwargs": {"ignore_label": 0, "lr": LR},
            "batches": batches, "eval_classes": NUM_CLASSES}


def _port_model():
    return ELKUNet(NUM_CLASSES, cr=CR, capacities=CAPS, device="cpu",
                   generator=torch.Generator().manual_seed(0))


def _jax_trees(state, grads=None):
    """A port state_dict (and its gradients) in the JAX trees."""
    sd = {k: v.numpy().copy() for k, v in state.items()}
    out = translate_elkunet(sd)
    if grads is not None:
        g = dict(sd, **{k: v.numpy().copy() for k, v in grads.items()})
        out["grads"] = translate_elkunet(g)["params"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 2-rank run (ranks' results and rank 0's snapshots), the
    JAX DP step's new state, metrics and gradients, and the JAX DP eval
    counters from the shared initial weights."""
    batches = _batches()
    job = _job(batches)
    workdir = str(tmp_path_factory.mktemp("dp"))
    ranks = dp_check.run_ranks([job], 2, "gloo", "cpu", workdir)

    variables = translate_elkunet({k: v.detach().numpy().copy() for k, v in
                                   _port_model().state_dict().items()})
    model = JELKUNet(num_classes=NUM_CLASSES, cr=CR, capacities=CAPS)
    mesh = JT.make_data_mesh(jax.devices()[:2])
    gb = JT.stack_device_batches(
        [{k: b[k] for k in ("feats", "coords", "labels", "nnz")}
         for b in batches])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state0 = JT.TrainState(step=jnp.int32(0), params=params,
                           batch_stats=stats, opt_state=None)
    _, jcounters = JT.make_dp_eval_step(model, mesh, NUM_CLASSES)(state0, gb)
    tx = _capturing(JT.make_sgd(lambda step: LR, momentum=0.9,
                                weight_decay=1e-4, nesterov=True))
    step = JT.make_dp_train_step(model, tx, mesh)
    new_state, jm = step(state0.replace(opt_state=tx.init(params)), gb)
    snap = torch.load(f"{workdir}/seg_dp.pt")
    return {"job": job, "ranks": ranks, "workdir": workdir, "snap": snap,
            "jax_state": new_state, "jax_metrics": jm,
            "jax_counters": np.asarray(jcounters)}


def test_dp_loss_terms_match_jax(runs):
    got, want = runs["snap"]["metrics"], runs["jax_metrics"]
    assert sorted(got) == sorted(want) == ["loss", "loss_ce", "loss_lovasz"]
    for k in got:
        assert abs(got[k] - float(want[k])) < 1e-4, k


def test_dp_gradients_match_jax(runs):
    port = _jax_trees(runs["snap"]["state"], runs["snap"]["grads"])
    got = flat(port["grads"], "params")
    want = flat(runs["jax_state"].opt_state[1], "params")
    assert sorted(got) == sorted(want) and len(got) > 100
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-3 * np.abs(w).max(), k


def test_dp_parameters_and_running_stats_match_jax(runs):
    port = _jax_trees(runs["snap"]["state"])
    jstate = runs["jax_state"]
    got = flat(port["params"], "params")
    want = flat(jstate.params, "params")
    assert sorted(got) == sorted(want)
    worst = max(np.abs(got[k] - w).max() / np.abs(w).max()
                for k, w in want.items())
    assert worst <= 1e-3
    got = flat(port["batch_stats"], "batch_stats")
    want = flat(jstate.batch_stats, "batch_stats")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k
    moved = [k for k in want if k.endswith("/mean")
             and np.abs(want[k]).max() > 0]
    assert len(moved) > 20       # the replicas' mean of moved estimates


def test_dp_eval_counters_equal_jax(runs):
    for r in runs["ranks"]:
        np.testing.assert_array_equal(
            np.asarray(r["jobs"]["seg"]["eval_counters"]),
            runs["jax_counters"])
    assert runs["jax_counters"][0].sum() > 0


def test_dp_ranks_equal_sequential_step_and_one_device_step(runs):
    """On the CPU, the 2-rank step equals `sequential_dp_step` (the
    replicas in turn, averaged, one update) and, with both ranks given
    replica 0's batch, the one-device step; the ranks' parameters are
    equal to the bit (else `hold` lists it under "failed")."""
    res = dp_check.hold(runs["job"], runs["ranks"], runs["workdir"],
                        torch.device("cpu"))
    for part in ("dp", "same"):
        assert res[part]["failed"] == [], res
        assert res[part]["loss_err"] <= 1e-6, res
        assert res[part]["grad"][0] <= 1e-6, res


def test_sequential_dp_step_matches_jax(runs):
    """The one-process form of the DP step (the card's reference) against
    JAX's DP step, within the same bounds."""
    model = _port_model()
    opt = TT.make_sgd(model.parameters(), LR)
    metrics = sequential_dp_step(
        lambda m, o, b: TT.seg_train_step(m, o, b, lr=LR), model, opt,
        runs["job"]["batches"])
    for k, v in metrics.items():
        assert abs(float(v) - float(runs["jax_metrics"][k])) < 1e-4, k
    port = _jax_trees({k: v.detach() for k, v in
                       model.state_dict().items()})
    jstate = runs["jax_state"]
    for coll, tol in (("params", 1e-3), ("batch_stats", 1e-5)):
        got = flat(port[coll], coll)
        want = flat(getattr(jstate, coll), coll)
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= tol * np.abs(w).max(), k


def test_dp_train_step_is_the_plain_step_on_one_process():
    """`make_dp_train_step` / `make_dp_eval_step` on a world of one (no
    group, no collective): the plain steps."""
    from link_tpu_torch.parallel import make_data_mesh
    mesh = make_data_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    b = _batches()[0]
    a, c = _port_model(), _port_model()
    ma = TT.make_dp_train_step(a, TT.make_sgd(a.parameters(), LR), mesh)(
        b, lr=LR)
    mc = TT.seg_train_step(c, TT.make_sgd(c.parameters(), LR), b, lr=LR)
    assert {k: float(v) for k, v in ma.items()} == {
        k: float(v) for k, v in mc.items()}
    for (k, x), y in zip(a.state_dict().items(), c.state_dict().values()):
        assert torch.equal(x, y), k
    _, got = TT.make_dp_eval_step(a, mesh, NUM_CLASSES)(b)
    _, want = TT.seg_eval_step(a, b, NUM_CLASSES)
    assert torch.equal(got, want)
    _, zeros = TT.make_dp_eval_step(a, mesh, NUM_CLASSES)(None)
    assert zeros.shape == (3, NUM_CLASSES) and not zeros.any()
