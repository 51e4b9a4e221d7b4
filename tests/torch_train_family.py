"""Shared setup of the per-family training-step tests
(`tests/test_torch_train_step_{minkunet,spvcnn,elkencoder}.py`): one step of
the port's `seg_train_step` against one jitted step of the JAX package's
`seg_train_step` from the same weights on the same batch, compared leaf by
leaf in the JAX trees.

The setup of tests/test_torch_train_step.py: cr 0.125, capacities (384, 192,
96, 48, 24), two synthetic scans made with numpy from seed 11, SGD (nesterov,
momentum 0.9, coupled weight decay 1e-4) under `cosine_warmup(0.05, 2, 2,
8)`, float32 on the CPU. The port's weights (its seeded init) go to the JAX
trees by `link_tpu.utils.torch_import.translate_*`; so do its gradients,
each `.grad` put in its parameter's `state_dict` slot
(`utils.convert.grads_state_dict`), and its parameters and batch statistics
after the step. The JAX optimizer is wrapped to hand back the gradients it
was given, so one forward and one backward are compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from link_tpu.train import schedules as JS
from link_tpu.train import trainer as JT
from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.train import trainer as TT
from link_tpu_torch.utils.convert import grads_state_dict

CAPS = (384, 192, 96, 48, 24)
CR = 0.125
SCHEDULE = (0.05, 2, 2, 8)     # base lr, epochs, batch, dataset size
LOSS_TOL = 1e-6                # absolute, each of the three loss parts


def batch(seed=11, grid_extent=None):
    """Two synthetic scans (0.4 m voxels, 160 voxels each) collated at
    CAPS[0]; `grid_extent` drops the voxels outside it, as the bench's
    training batches."""
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=seed)
    return collate_scans([ds[0], ds[1]], CAPS[0], grid_extent=grid_extent)


def generator(seed=0):
    return torch.Generator().manual_seed(seed)


def _capturing(tx):
    """`tx`, whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_step(model):
    """(jitted step, state maker): step(state, batch) -> (new state,
    metrics); the new state's `opt_state[1]` holds the step's gradients."""
    tx = _capturing(JT.make_sgd(JS.cosine_warmup(*SCHEDULE), momentum=0.9,
                                weight_decay=1e-4, nesterov=True))

    def step(state, b):
        return JT.seg_train_step(model, tx, state, b)

    def make_state(variables):
        return JT.TrainState(step=jnp.int32(0), params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]))

    return jax.jit(step), make_state


def flat(tree, coll):
    return {coll + "/" + "/".join(str(getattr(k, "key", k)) for k in p):
            np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def run_both(port, jmodel, translate, b):
    """One step of each package from the port's weights on batch `b`:
    {"loss": (port, jax) per loss part, "grads": (port, jax) flat dicts,
    "state": (port, jax) flat dicts of parameters and batch statistics}."""
    step, make_state = jax_step(jmodel)
    # copies: JAX may alias a numpy buffer on the CPU, and the port's
    # optimizer updates its parameters in place
    state = make_state(translate({k: t.detach().clone().numpy()
                                  for k, t in port.state_dict().items()}))
    jb = {k: jnp.asarray(b[k]) for k in ("feats", "coords", "labels", "nnz")}
    new_state, jm = step(state, jb)
    opt = TT.make_sgd(port.parameters(), 1.0)
    tm = TT.seg_train_step(port, opt, b, ignore_label=0,
                           lr=TS.cosine_warmup(*SCHEDULE)(0))
    tgrads = translate(grads_state_dict(port))["params"]
    tstate = translate({k: t.detach().numpy()
                        for k, t in port.state_dict().items()})
    return {
        "loss": {k: (float(tm[k]), float(jm[k])) for k in tm},
        "grads": (flat(tgrads, "params"), flat(new_state.opt_state[1],
                                               "params")),
        "state": ({**flat(tstate["params"], "params"),
                   **flat(tstate["batch_stats"], "batch_stats")},
                  {**flat(new_state.params, "params"),
                   **flat(new_state.batch_stats, "batch_stats")}),
    }


def check_loss(out):
    """Each loss part within LOSS_TOL of JAX's."""
    assert sorted(out["loss"]) == ["loss", "loss_ce", "loss_lovasz"]
    for k, (got, want) in out["loss"].items():
        assert np.isfinite(want) and abs(got - want) <= LOSS_TOL, (k, got,
                                                                    want)


def check_grads(out, tol, zero_grad_leaves=()):
    """Every gradient within `tol` of its leaf's largest magnitude; the
    leaves in `zero_grad_leaves` (a true gradient of 0, float noise on both
    sides) within `tol` of the largest gradient of all instead. Returns the
    worst share."""
    worst = 0.0
    got, want = out["grads"]
    assert sorted(got) == sorted(want) and len(got) > 40
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = top if k in zero_grad_leaves else float(np.abs(w).max())
        assert scale > 0, k
        if k in zero_grad_leaves:
            assert np.abs(w).max() < 1e-6 * top, k   # noise, not a gradient
        err = float(np.abs(got[k] - w).max()) / scale
        worst = max(worst, err)
        assert err <= tol, (k, err)
    assert set(zero_grad_leaves) <= set(want)
    return worst


def check_state(out, tol):
    """Every parameter and batch statistic after the step within `tol` of
    its leaf's largest magnitude. Returns the worst share of each."""
    worst = {}
    got, want = out["state"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                    1e-30)
        kind = k.split("/")[0]
        worst[kind] = max(worst.get(kind, 0.0), err)
        assert err <= tol, (k, err)
    moved = [k for k in want if k.startswith("batch_stats/")
             and k.endswith("/mean") and np.abs(want[k]).max() > 0]
    assert len(moved) >= 10          # the running statistics did move
    return worst
