"""The port's SPVCNN training step against the JAX package's, leaf by
leaf (tests/torch_train_family.py has the setup): the three loss parts
within 1e-6, every gradient, parameter and batch statistic after the step
within 1e-4 of its leaf's largest magnitude. float32 on both sides.

Two traps:
  * both sides run at dropout_rate 0: JAX's `seg_train_step`
    (link_tpu/train/trainer.py:51-80) passes no dropout RNG, so the JAX
    SPVCNN cannot train with dropout; the port's seeded dropout is held by
    tests/test_torch_spvcnn.py;
  * the point MLPs' Linear biases (`pt0`-`pt2`, reference keys
    `point_transforms.*.0.bias`) feed a BatchNorm, so their true gradient
    is 0 and both sides give float noise: they are bounded against the
    largest gradient of all, not their own.
"""

import os

import pytest
import torch

from link_tpu.models.spvcnn import SPVCNN as JSPVCNN
from link_tpu.utils.torch_import import translate_spvcnn
from link_tpu_torch.models import builder
from link_tpu_torch.models.spvcnn import SPVCNN
from link_tpu_torch.utils.config import load_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_family import (CAPS, CR, batch, check_grads, check_loss,
                                check_state, generator, run_both)

TOL = 1e-4
ZERO_GRAD = tuple(f"params/pt{i}/Linear_0/bias" for i in range(3))
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "semantic_kitti", "spvcnn",
    "default.yaml")


@pytest.fixture(scope="module")
def out():
    port = SPVCNN(20, cr=CR, capacities=CAPS, dropout_rate=0.0, device="cpu",
                  generator=generator())
    return run_both(port, JSPVCNN(num_classes=20, cr=CR, capacities=CAPS,
                                  dropout_rate=0.0),
                    translate_spvcnn, batch())


def test_spvcnn_train_loss_matches_jax(out):
    check_loss(out)


def test_spvcnn_gradients_match_jax(out):
    check_grads(out, TOL, zero_grad_leaves=ZERO_GRAD)


def test_spvcnn_parameters_and_batch_stats_after_a_step_match_jax(out):
    check_state(out, TOL)


def test_builder_passes_the_dropout_rate():
    """`model.dropout_rate` reaches SPVCNN (0.3, the reference's, without
    it); at 0 a training-mode forward draws nothing and needs no seed."""
    kw = dict(capacities=CAPS, device="cpu")
    assert builder.make_model(load_config(CONFIG, ["model.cr=0.125"]),
                              **kw).dropout_rate == 0.3
    model = builder.make_model(load_config(
        CONFIG, ["model.cr=0.125", "model.dropout_rate=0"]), **kw)
    assert model.dropout_rate == 0 and model.dropout_seed is None
    f = torch.ones((10, 4))
    assert model.train()._drop(f) is f
