"""The port's MinkUNet against the reference golden and the JAX MinkUNet:
state-dict keys, logits, parameter conversion, a channel-plan override and
bfloat16.

Logits are compared as max|port - ref| / max|ref| < 2e-4, the bound of the
JAX package's golden tests (float32, the sums of ~30 layers in another
order), at the capacities those tests pin (tests/test_golden_parity.py:
82-84). Each JAX forward is jitted once per module and shared by the tests
that give it trees of the same shapes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from link_tpu.models import builder as jbuilder
from link_tpu.models.minkunet import MinkUNet as JMinkUNet
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils import config as jconfig
from link_tpu.utils.torch_import import translate_minkunet
from link_tpu_torch.models import builder as tbuilder
from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils import config as tconfig
from link_tpu_torch.utils.convert import (from_jax_minkunet,
                                          load_reference_state_dict)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "minkunet_cr0.25.npz")
CONFIG = os.path.join(REPO, "configs", "semantic_kitti", "minkunet",
                      "default.yaml")
GOLDEN_CAPS = (1024, 640, 256, 128, 64)
TOL = 2e-4
STOCK = [32, 32, 64, 128, 256, 256, 128, 96, 96]   # the SPVNAS plan


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.fixture(scope="module")
def golden():
    """(feats, coords, nnz, logits, reference state_dict as numpy)."""
    g = np.load(GOLDEN)
    n, cap = len(g["coords"]), GOLDEN_CAPS[0]
    c = np.full((cap, 4), -(2**20), np.int32)
    f = np.zeros((cap, 4), np.float32)
    c[:n], f[:n] = g["coords"], g["feats"]
    sd = {k[3:].replace("__", "."): np.array(g[k]) for k in g.files
          if k.startswith("sd_")}
    return f, c, n, g["logits"], sd


def _port_logits(model, f, c, n):
    model.eval()
    with torch.inference_mode():
        return model(t_make(f, c, nnz=n, device="cpu")).float().numpy()[:n]


def _port(sd, dtype="float32", **kw):
    model = MinkUNet(20, cr=0.25, capacities=GOLDEN_CAPS, dtype=dtype,
                     device="cpu", **kw)
    load_reference_state_dict(model, {k: torch.from_numpy(np.array(v))
                                      for k, v in sd.items()})
    return model


def _jax_forward(model):
    return jax.jit(lambda v, f, c, n: model.apply(v, j_make(f, c, nnz=n),
                                                  False))


@pytest.fixture(scope="module")
def jax_forward():
    return _jax_forward(JMinkUNet(num_classes=20, cr=0.25,
                                  capacities=GOLDEN_CAPS))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's own init (parameters do not depend on the
    capacities, so a tiny input suffices), batch stats perturbed by
    numpy."""
    model = JMinkUNet(num_classes=20, cr=0.25, capacities=(64,) * 5)
    c = np.full((64, 4), -(2**20), np.int32)
    c[:8] = [[i % 3, i // 3 % 3, i // 2, 0] for i in range(8)]
    v = jax.jit(lambda k, f, c: model.init(k, j_make(f, c, nnz=8), False))(
        jax.random.PRNGKey(3), np.zeros((64, 4), np.float32), c)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(-0.2, 0.2, a.shape).astype(
            np.float32), v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, v["params"]), stats


def test_state_dict_matches_reference_keys(golden):
    ref = golden[4]
    sd = MinkUNet(20, cr=0.25, capacities=GOLDEN_CAPS, device="cpu"
                  ).state_dict()
    unused = [k for k in ref if k.startswith(MinkUNet.UNUSED_REFERENCE_KEYS)]
    assert MinkUNet.UNUSED_REFERENCE_KEYS == ("point_transforms.",)
    assert len(unused) == 21
    assert sorted(sd) == sorted(set(ref) - set(unused))
    for k in sd:
        assert tuple(sd[k].shape) == ref[k].shape, k


def test_port_matches_reference_golden(golden):
    f, c, n, want, sd = golden
    assert _rel(_port_logits(_port(sd), f, c, n), want) < TOL


def test_port_matches_jax_minkunet(jax_forward, golden):
    f, c, n, _, sd = golden
    want = np.asarray(jax_forward(translate_minkunet(sd), f, c, n))[:n]
    assert _rel(_port_logits(_port(sd), f, c, n), want) < TOL


def test_from_jax_round_trip_is_exact(jax_init):
    params, stats = jax_init
    back = translate_minkunet({k: v.numpy() for k, v in
                               from_jax_minkunet(params, stats).items()})
    for tree, want in ((back["params"], params),
                       (back["batch_stats"], stats)):
        got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
               jax.tree_util.tree_leaves_with_path(tree)}
        flat = jax.tree_util.tree_leaves_with_path(want)
        assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in flat)
        for p, a in flat:
            np.testing.assert_array_equal(got[jax.tree_util.keystr(p)], a)


def test_from_jax_gives_the_jax_logits(jax_forward, jax_init, golden):
    params, stats = jax_init
    f, c, n = golden[:3]
    sd = from_jax_minkunet(params, stats)
    want = np.asarray(jax_forward(translate_minkunet(
        {k: v.numpy() for k, v in sd.items()}), f, c, n))[:n]
    got = _port_logits(_port(sd), f, c, n)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel(got, want) < TOL


def test_channels_override_matches_jax(golden):
    """`model.channels` selects the stock plan in both packages' builders:
    widths 8-64 at cr 0.25, 24 among them (no multiple of 16). The port's
    own seeded init, batch stats perturbed by numpy, runs through both."""
    f, c, n = golden[:3]
    ov = [f"model.channels={STOCK}".replace(" ", ""), "model.cr=0.25"]
    jmodel = jbuilder.make_model(jconfig.load_config(CONFIG, ov),
                                 capacities=GOLDEN_CAPS)
    port = tbuilder.make_model(tconfig.load_config(CONFIG, ov),
                               capacities=GOLDEN_CAPS, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    assert port.cs == [int(0.25 * c) for c in STOCK]
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf += torch.from_numpy(rng.uniform(
                    0, 0.2, buf.shape).astype(np.float32))
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    want = np.asarray(_jax_forward(jmodel)(translate_minkunet(sd), f, c,
                                           n))[:n]
    assert np.abs(want).max() > 0
    assert _rel(_port_logits(port, f, c, n), want) < TOL


def test_bfloat16_forward_stays_near_float32(golden):
    """bfloat16 runs the same graph with 8-bit mantissas: finite logits
    within 5% of the float32 ones (relative to their largest magnitude)."""
    f, c, n, _, sd = golden
    ref = _port_logits(_port(sd), f, c, n)
    got = _port_logits(_port(sd, "bfloat16"), f, c, n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) < 5e-2
