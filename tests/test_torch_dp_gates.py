"""The gates that `link_tpu_torch.tools.dp_check` holds a data-parallel step
by, and `tools.grad_gap`'s comparison of two runs, on the CPU.

The gradient readings (`grad_gaps`) must read a near-zero entry that lands
on the other side of a ReLU as a small share of the whole, and the
reduction faults (the sum for the mean, replica 0's gradient alone) as
far outside the limits; `compare` must refuse those faults and a
parameter update that is not the optimizer's on the rank's own gradient.
A tiny ELKUNet (the capacities of tests/test_train.py), two synthetic
scans made with numpy; no JAX.
"""

import functools

import pytest
import torch

from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.tools import dp_check, grad_gap
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = (512, 256, 128, 64, 32)
LR = 0.05
LEAF = "stage3.1.net.3.kernel"


def _job():
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=11)
    return {"name": "seg", "step": "seg", "seed": 0,
            "model": functools.partial(ELKUNet, 20, cr=0.125,
                                       capacities=CAPS),
            "optimizer": functools.partial(dp_check.sgd, lr=LR),
            "step_kwargs": {"ignore_label": 0, "lr": LR},
            "batches": [collate_scans([ds[r]], CAPS[0]) for r in range(2)]}


@pytest.fixture(scope="module")
def refs():
    job = _job()
    cpu = torch.device("cpu")
    out = {"job": job}
    for part in ("dp", "same"):
        ref = dp_check._reference(job, cpu, part)
        ref["state"] = {k: v.detach().clone() for k, v in
                        ref["model"].state_dict().items()}
        del ref["model"], ref["opt"]
        out[part] = ref
    return out


def _snap(ref, grads=None, state=None):
    return {"metrics": dict(ref["metrics"]),
            "grads": grads if grads is not None else ref["grads"],
            "state": state if state is not None else ref["state"]}


def _limits(ref):
    return dp_check.grad_limits(dp_check.grad_gaps(ref["grads"],
                                                   ref["grads"]))


def test_grad_gaps_read_the_reduction_faults(refs):
    g = refs["dp"]["grads"]
    same = dp_check.grad_gaps(g, g)
    assert same["norm"] == same["dist"] == 0.0
    assert max(same["leaves"].values()) == 0.0
    double = dp_check.grad_gaps({k: 2 * v for k, v in g.items()}, g)
    assert double["norm"] == pytest.approx(1.0)
    assert double["dist"] == pytest.approx(1.0)
    big = [k for k, v in g.items() if float(v.norm()) > 1e-3]
    assert all(double["leaves"][k] == pytest.approx(1.0) for k in big)
    alone = dp_check.grad_gaps(refs["same"]["grads"], g)
    assert alone["dist"] > 0.1


def test_grad_gaps_read_a_flipped_entry_as_its_share(refs):
    """One entry of the leaf's largest magnitude given the other sign: the
    entry reading sees 2, the gated readings its share of the whole."""
    g = refs["dp"]["grads"]
    w = g[LEAF]
    i = int(w.abs().argmax())
    flipped = dict(g)
    flipped[LEAF] = w.clone().reshape(-1)
    flipped[LEAF][i] = -flipped[LEAF][i]
    flipped[LEAF] = flipped[LEAF].view_as(w)
    assert dp_check._entry_worst(flipped, g)[0] == pytest.approx(2.0)
    gaps = dp_check.grad_gaps(flipped, g)
    whole = float(torch.sqrt(sum(v.double().square().sum()
                                 for v in g.values())))
    assert gaps["dist"] == pytest.approx(2 * float(w.abs().max()) / whole,
                                         rel=1e-6)
    assert gaps["norm"] < 1e-12 and gaps["leaves"][LEAF] < 1e-12


def test_grad_limits_scale_the_repeat_and_keep_the_floor():
    """The limits follow the repeat's distance (global, and leaf by leaf
    for the leaves), not its norms' gaps, and keep the floor."""
    repeat = {"norm": 0.0, "dist": 5e-5, "leaves": {"a": 0.0, "b": 0.0},
              "leaf_dist": {"a": 0.5, "b": 0.0}}
    lim = dp_check.grad_limits(repeat)
    assert lim["norm"] == lim["dist"] == dp_check.GRAD_FLOOR
    repeat["dist"] = 3e-3
    lim = dp_check.grad_limits(repeat)
    assert lim["norm"] == lim["dist"] == pytest.approx(
        dp_check.GRAD_FACTOR * 3e-3)
    assert lim["leaves"] == {"a": dp_check.GRAD_FACTOR * 0.5,
                             "b": dp_check.GRAD_FLOOR}
    shares = dp_check.grad_shares({"norm": 1e-3, "dist": 1e-3,
                                   "leaves": {"a": 1.0, "b": 1e-2}}, lim)
    assert shares["leaf"][:2] == (pytest.approx(10.0), "b")


def test_compare_holds_the_reference_step(refs):
    cpu = torch.device("cpu")
    for part in ("dp", "same"):
        ref = refs[part]
        out = dp_check.compare(refs["job"], _snap(ref), ref, _limits(ref),
                               cpu)
        assert out["failed"] == [], out
        assert out["param_share_of_bound"][0] == 0.0


@pytest.mark.parametrize("fault", ["sum for mean", "replica 0 alone"])
def test_compare_refuses_a_reduction_fault(refs, fault):
    ref = refs["dp"]
    grads = ({k: 2 * v for k, v in ref["grads"].items()}
             if fault == "sum for mean" else refs["same"]["grads"])
    # the rank's parameters are its optimizer's update of these gradients,
    # so only the gradient hold can see the fault
    state = dict(ref["state"], **dp_check._replayed(
        refs["job"], torch.device("cpu"), grads))
    out = dp_check.compare(refs["job"], _snap(ref, grads, state), ref,
                           _limits(ref), torch.device("cpu"))
    assert out["failed"] == ["gradients"], out
    assert out["param_share_of_bound"][0] == 0.0


def test_compare_refuses_an_update_off_the_gradient(refs):
    """The parameters of the reference step with the rank's gradient one
    leaf off: the update is not the optimizer's on that gradient."""
    ref = refs["dp"]
    grads = dict(ref["grads"])
    grads[LEAF] = grads[LEAF] * (1 + 1e-4)
    out = dp_check.compare(refs["job"], _snap(ref, grads), ref,
                           _limits(ref), torch.device("cpu"))
    assert out["failed"] == ["params"], out
    assert out["param_share_of_bound"][1] == LEAF


def test_grad_gap_compare_runs_finds_the_first_difference():
    """Two CPU runs of one step are equal to the bit; a planted change of
    one ReLU input is the first difference and its flips are counted."""
    job = _job()
    job["batches"] = job["batches"][:1]
    cpu = torch.device("cpu")
    a, b = grad_gap.run_step(job, cpu), grad_gap.run_step(job, cpu)
    same = grad_gap.compare_runs(a, b, LEAF)
    assert same["modules_differing"] == 0 and same["relu_flips"] == 0
    assert same["grad_dist"] == 0.0 and same["leaf_entry_gap"] == 0.0
    relu = "stage3.1.net.2"
    x = b["relu"][relu].clone()
    pos = x > 0
    assert pos.any()
    x[pos] = -x[pos]
    b["relu"][relu] = x
    b["digest"][relu] = "changed"
    moved = grad_gap.compare_runs(a, b, LEAF)
    assert moved["first_differing"] == relu
    assert moved["relu_flips"] == int(pos.sum())
    assert moved["first_flip"][0] == relu
