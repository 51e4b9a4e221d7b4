"""The port's SPVCNN against the reference golden and the JAX SPVCNN:
state-dict keys, logits, parameter conversion and the dropout's contract.

The golden is the reference point-voxel U-Net at cr 0.25 on integer point
positions (pres = vres = 1), at the capacities the JAX golden tests pin
(tests/test_golden_parity.py:82-84: a 512 level-1 cap drops 2 rows of this
cloud). Logits are compared as max|port - ref| / max|ref| < 2e-4, the bound
of those tests: float32, the sums of ~30 layers in another order. The JAX
forward is jitted once per module.
"""

import os

import jax
import numpy as np
import pytest
import torch

from link_tpu.models.spvcnn import SPVCNN as JSPVCNN
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.torch_import import translate_spvcnn
from link_tpu_torch.models.spvcnn import SPVCNN
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils.convert import (from_jax_spvcnn,
                                          load_reference_state_dict)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "spvcnn_cr0.25.npz")
GOLDEN_CAPS = (1024, 640, 256, 128, 64)
TOL = 2e-4


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


def _port(sd=None, **kw):
    model = SPVCNN(20, cr=0.25, pres=1.0, vres=1.0, capacities=GOLDEN_CAPS,
                   device="cpu", **kw)
    if sd is not None:
        load_reference_state_dict(model, {k: torch.from_numpy(np.array(v))
                                          for k, v in sd.items()})
    return model.eval()


def _port_logits(model, f, c, n):
    with torch.inference_mode():
        return model(t_make(f, c, nnz=n, device="cpu")).float().numpy()[:n]


@pytest.fixture(scope="module")
def jax_forward():
    model = JSPVCNN(num_classes=20, cr=0.25, capacities=GOLDEN_CAPS,
                    pres=1.0, vres=1.0)
    return jax.jit(lambda v, f, c, n: model.apply(v, j_make(f, c, nnz=n),
                                                  False))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's own init (parameters do not depend on the
    capacities, so a tiny input suffices), batch stats perturbed by
    numpy."""
    model = JSPVCNN(num_classes=20, cr=0.25, capacities=(64,) * 5)
    c = np.full((64, 4), -(2**20), np.int32)
    c[:8] = [[i % 3, i // 3 % 3, i // 2, 0] for i in range(8)]
    v = jax.jit(lambda k, f, c: model.init(k, j_make(f, c, nnz=8), False))(
        jax.random.PRNGKey(3), np.zeros((64, 4), np.float32), c)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(-0.2, 0.2, a.shape).astype(
            np.float32), v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, v["params"]), stats


def test_state_dict_matches_reference_keys(golden):
    ref = golden[4]
    sd = _port().state_dict()
    assert not hasattr(SPVCNN, "UNUSED_REFERENCE_KEYS")
    assert sorted(sd) == sorted(ref) and len(sd) == 317
    for k in sd:
        assert tuple(sd[k].shape) == ref[k].shape, k


def test_port_matches_reference_golden(golden):
    f, c, n, want, sd = golden
    assert _rel(_port_logits(_port(sd), f, c, n), want) < TOL


def test_port_matches_jax_spvcnn(jax_forward, golden):
    f, c, n, _, sd = golden
    want = np.asarray(jax_forward(translate_spvcnn(sd), f, c, n))[:n]
    assert _rel(_port_logits(_port(sd), f, c, n), want) < TOL


def test_from_jax_round_trip_is_exact(jax_init):
    params, stats = jax_init
    back = translate_spvcnn({k: v.numpy() for k, v in
                             from_jax_spvcnn(params, stats).items()})
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
    sd = from_jax_spvcnn(params, stats)
    want = np.asarray(jax_forward(translate_spvcnn(
        {k: v.numpy() for k, v in sd.items()}), f, c, n))[:n]
    got = _port_logits(_port(sd), f, c, n)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel(got, want) < TOL


def test_dropout_runs_in_training_only_from_its_seed(golden):
    """Eval mode draws nothing; training mode drops ~30% of the entries and
    scales the rest by 1 / 0.7, from a generator seeded by `dropout_seed`
    (the same mask for the same seed); without a seed it raises."""
    f = torch.ones((4000, 8))
    model = _port(dropout_seed=7)
    assert model._drop(f) is f
    model.train()
    a, b = model._drop(f), _port(dropout_seed=7).train()._drop(f)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert not torch.equal(model._drop(f), a)       # the stream moves on
    with pytest.raises(ValueError, match="dropout_seed"):
        _port().train()._drop(f)
