"""The port's training objectives, schedule and metric against the JAX
package and the reference goldens.

Same numpy inputs through `link_tpu.train.{losses,schedules,metrics}` and
their counterparts in `link_tpu_torch.train`. Tolerances:
  * loss values: 1e-5 absolute, the bound of tests/test_golden_losses.py
    (float32 on both sides, sums over ~500 rows in another order);
  * gradients w.r.t. the logits: 1e-5 of the gradient's largest magnitude.
    Both sides route the Lovász gradient through one stable sort of the
    detached errors, so ties fall the same way;
  * the schedule: rtol 1e-5, atol 1e-7 as the golden test. The JAX schedule
    evaluates in float32, the port's in Python floats;
  * IoU counters: exact (integers).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.train import losses as JL
from link_tpu.train import metrics as JM
from link_tpu.train import schedules as JS
from link_tpu_torch.train import losses as TL
from link_tpu_torch.train import metrics as TM
from link_tpu_torch.train import schedules as TS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "losses.npz")


def _case(seed, n=400, c=7, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c)).astype(np.float32) * 2
    if ties:
        # rows repeated, so many errors tie exactly and the sort's tie rule
        # decides the Lovász weights
        logits[n // 2:] = logits[:n - n // 2]
    labels = rng.integers(0, c, n).astype(np.int32)
    if ties:
        labels[n // 2:] = labels[:n - n // 2]
    valid = rng.random(n) < 0.8
    return logits, labels, valid


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


LOSSES = {
    "cross_entropy": (
        lambda lg, lb, v: JL.cross_entropy(lg, lb, v),
        lambda lg, lb, v: TL.cross_entropy(lg, lb, v)),
    "lovasz_softmax": (
        lambda lg, lb, v: JL.lovasz_softmax(jax.nn.softmax(lg, -1), lb, v),
        lambda lg, lb, v: TL.lovasz_softmax(torch.softmax(lg, -1), lb, v)),
    "segmentation_loss": (
        lambda lg, lb, v: JL.segmentation_loss(lg, lb, v)[0],
        lambda lg, lb, v: TL.segmentation_loss(lg, lb, v)[0]),
}


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_logit_gradient_match_jax(name, ties):
    jfn, tfn = LOSSES[name]
    logits, labels, valid = _case(1, ties=ties)
    want, gwant = jax.value_and_grad(jfn)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tfn(lg, torch.from_numpy(labels), torch.from_numpy(valid))
    got.backward()
    assert abs(float(got.detach()) - float(want)) < 1e-5
    assert np.abs(np.asarray(gwant)).max() > 0
    assert _rel(lg.grad.numpy(), np.asarray(gwant)) < 1e-5


def test_segmentation_loss_parts_and_empty_batch():
    logits, labels, valid = _case(2)
    _, jaux = JL.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(valid))
    loss, aux = TL.segmentation_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(valid))
    assert sorted(aux) == sorted(jaux) == ["loss_ce", "loss_lovasz"]
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) < 1e-5
    assert abs(float(loss) - float(aux["loss_ce"] + aux["loss_lovasz"])) < 1e-6
    # nothing kept (all rows padding): both parts are exactly zero
    none = torch.zeros(len(labels), dtype=torch.bool)
    loss0, _ = TL.segmentation_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels), none)
    assert float(loss0) == 0.0


def test_lovasz_ignores_padding_rows_like_jax():
    """Padding folded into `keep`: appending invalid rows changes nothing."""
    logits, labels, valid = _case(3, n=200)
    pad = 56
    lg = np.concatenate([logits, np.full((pad, logits.shape[1]), 7.0, np.float32)])
    lb = np.concatenate([labels, np.ones(pad, np.int32)])
    va = np.concatenate([valid, np.zeros(pad, bool)])
    a = TL.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             torch.from_numpy(valid))[0]
    b = TL.segmentation_loss(torch.from_numpy(lg), torch.from_numpy(lb),
                             torch.from_numpy(va))[0]
    assert abs(float(a) - float(b)) < 1e-6


def test_lovasz_matches_reference_golden():
    """As tests/test_golden_losses.py:25, the reference torch value."""
    g = np.load(GOLDEN)
    logits = torch.from_numpy(g["lovasz_logits"])
    labels = torch.from_numpy(g["lovasz_labels"].astype(np.int32))
    got = float(TL.lovasz_softmax(torch.softmax(logits, 1), labels,
                                  torch.ones(labels.shape, dtype=torch.bool),
                                  ignore_index=0))
    assert abs(got - float(g["lovasz_value"])) < 1e-5


@pytest.mark.parametrize("world", [1, 4])
def test_cosine_warmup_matches_jax_and_golden(world):
    g = np.load(GOLDEN)
    steps = g["cw_steps"]
    port = TS.cosine_warmup(1.0, 25, 2 * world, 19130, world_size=world)
    ref = JS.cosine_warmup(1.0, 25, 2 * world, 19130, world_size=world)
    got = np.asarray([port(int(s)) for s in steps])
    np.testing.assert_allclose(got, g[f"cw_mult_w{world}"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got, [float(ref(s)) for s in steps],
                               rtol=1e-5, atol=1e-7)
    assert isinstance(port(3), float)


def test_cosine_warmup_of_the_seg_recipe():
    """lr 0.24, 25 epochs, batch 2, 19,132 scans: the schedule the trainer
    sets from, against the JAX one at a few steps of the run."""
    port = TS.cosine_warmup(0.24, 25, 2, 19132)
    ref = JS.cosine_warmup(0.24, 25, 2, 19132)
    for s in (0, 1, 6, 9566, 120000, 239149):
        assert abs(port(s) - float(ref(s))) < 1e-5 * 0.24
    assert port(0) == 0.24


def test_iou_counters_and_miou_match_jax():
    rng = np.random.default_rng(5)
    n, c = 500, 20
    preds = rng.integers(0, c, n).astype(np.int32)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[labels == 7] = 3                      # one class never seen
    valid = rng.random(n) < 0.9
    want = np.asarray(JM.iou_counters(jnp.asarray(preds), jnp.asarray(labels),
                                      jnp.asarray(valid), c, 0))
    got = TM.iou_counters(torch.from_numpy(preds), torch.from_numpy(labels),
                          torch.from_numpy(valid), c, 0)
    assert got.dtype == torch.int32 and got.shape == (3, c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert TM.miou_from_counters(got.numpy()) == JM.miou_from_counters(want)
    jm, tm = JM.MeanIoU(c), TM.MeanIoU(c)
    for _ in range(2):
        jm.update(want)
        tm.update(got)                            # takes the tensor itself
    assert tm.compute() == jm.compute()
    np.testing.assert_array_equal(tm.per_class(), jm.per_class())
