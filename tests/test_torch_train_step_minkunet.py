"""The port's MinkUNet training step against the JAX package's, leaf by
leaf (tests/torch_train_family.py has the setup): the three loss parts
within 1e-6, every gradient, parameter and batch statistic after the step
within 1e-4 of its leaf's largest magnitude. float32 on both sides; the
sums of ~40 layers in another order.
"""

import pytest

from link_tpu.models.minkunet import MinkUNet as JMinkUNet
from link_tpu.utils.torch_import import translate_minkunet
from link_tpu_torch.models.minkunet import MinkUNet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_family import (CAPS, CR, batch, check_grads, check_loss,
                                check_state, generator, run_both)

TOL = 1e-4


@pytest.fixture(scope="module")
def out():
    port = MinkUNet(20, cr=CR, capacities=CAPS, device="cpu",
                    generator=generator())
    return run_both(port, JMinkUNet(num_classes=20, cr=CR, capacities=CAPS),
                    translate_minkunet, batch())


def test_minkunet_train_loss_matches_jax(out):
    check_loss(out)


def test_minkunet_gradients_match_jax(out):
    check_grads(out, TOL)


def test_minkunet_parameters_and_batch_stats_after_a_step_match_jax(out):
    check_state(out, TOL)
