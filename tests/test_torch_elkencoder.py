"""The port's ELKEncoder against the reference golden and the JAX
ELKEncoder: state-dict keys, logits through both ELK aux paths, parameter
conversion, the ELK block's coordinate normalisation under cos_x, and
bfloat16.

The golden is the reference encoder at r=3, s=5, groups=2 and the cos
basis (tests/test_golden_parity.py:113-114), at the capacities the JAX
golden tests pin (:82-84). Logits are compared as max|port - ref| /
max|ref| < 2e-4, the bound of those tests: float32, the sums of ~40 layers
in another order. The JAX forward is jitted once per module.
"""

import os

import jax
import numpy as np
import pytest
import torch

from link_tpu.models.elk import ELKBlock as JELKBlock
from link_tpu.models.linkencoder import ELKEncoder as JELKEncoder
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.torch_import import translate_elkencoder
from link_tpu_torch.models import elk as telk_model
from link_tpu_torch.models.elk import ELKBlock
from link_tpu_torch.models.linkencoder import ELKEncoder
from link_tpu_torch.ops.elk import use_dense_aux
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils.convert import (from_jax_elkencoder,
                                          load_reference_state_dict)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "elkencoder_cr0.25.npz")
GOLDEN_CAPS = (1024, 640, 256, 128, 64)
ARCH = dict(r=3, s=5, groups=2, baseop="cos")
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


def _extent(c, n):
    """A grid extent that bounds the cloud: every ELK level fits the dense
    aux grid."""
    return tuple(int(v) for v in c[:n, :3].max(0) + 1) + (1,)


def _port(sd, dtype="float32", grid_extent=None):
    model = ELKEncoder(20, cr=0.25, capacities=GOLDEN_CAPS, dtype=dtype,
                       grid_extent=grid_extent, device="cpu", **ARCH)
    load_reference_state_dict(model, {k: torch.from_numpy(np.array(v))
                                      for k, v in sd.items()})
    return model.eval()


def _port_logits(model, f, c, n):
    with torch.inference_mode():
        return model(t_make(f, c, nnz=n, device="cpu")).float().numpy()[:n]


@pytest.fixture(scope="module")
def jax_forward():
    model = JELKEncoder(num_classes=20, cr=0.25, capacities=GOLDEN_CAPS,
                        **ARCH)
    return jax.jit(lambda v, f, c, n: model.apply(v, j_make(f, c, nnz=n),
                                                  False))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's own init (parameters do not depend on the
    capacities, so a tiny input suffices), batch stats perturbed by
    numpy."""
    model = JELKEncoder(num_classes=20, cr=0.25, capacities=(64,) * 5,
                        **ARCH)
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
    sd = ELKEncoder(20, cr=0.25, capacities=GOLDEN_CAPS, device="cpu",
                    **ARCH).state_dict()
    unused = [k for k in ref if k.startswith(ELKEncoder.UNUSED_REFERENCE_KEYS)]
    assert ELKEncoder.UNUSED_REFERENCE_KEYS == ("up1.", "up2.", "up3.", "up4.")
    assert len(unused) == 4 * 36
    assert sorted(sd) == sorted(set(ref) - set(unused))
    for k in sd:
        assert tuple(sd[k].shape) == ref[k].shape, k


@pytest.mark.parametrize("aux", ["sparse", "dense"])
def test_port_matches_reference_golden(golden, aux, monkeypatch):
    """Through the sparse aux join on every level, and with a grid extent
    through the dense aux grid on every level."""
    f, c, n, want, sd = golden
    ext = _extent(c, n) if aux == "dense" else None
    dense_calls = []
    real = telk_model.elk_aux_window_dense
    monkeypatch.setattr(telk_model, "elk_aux_window_dense",
                        lambda *a: dense_calls.append(a[2]) or real(*a))
    got = _port_logits(_port(sd, grid_extent=ext), f, c, n)
    assert dense_calls == ([10, 20, 40, 80] if aux == "dense" else [])
    assert _rel(got, want) < TOL


def test_port_matches_jax_elkencoder(jax_forward, golden):
    f, c, n, _, sd = golden
    want = np.asarray(jax_forward(translate_elkencoder(sd), f, c, n))[:n]
    assert _rel(_port_logits(_port(sd), f, c, n), want) < TOL


def test_from_jax_round_trip_is_exact(jax_init):
    params, stats = jax_init
    back = translate_elkencoder({k: v.numpy() for k, v in
                                 from_jax_elkencoder(params, stats).items()})
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back["params"])
    assert [p for p, _ in flat_p] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))
    got_s = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(back["batch_stats"])}
    for p, a in jax.tree_util.tree_leaves_with_path(stats):
        np.testing.assert_array_equal(got_s[jax.tree_util.keystr(p)], a)


def test_from_jax_gives_the_jax_logits(jax_forward, jax_init, golden):
    params, stats = jax_init
    f, c, n = golden[:3]
    sd = from_jax_elkencoder(params, stats)
    want = np.asarray(jax_forward(translate_elkencoder(
        {k: v.numpy() for k, v in sd.items()}), f, c, n))[:n]
    got = _port_logits(_port(sd), f, c, n)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("aux", ["sparse", "dense"])
def test_normalized_cos_x_block_matches_jax(golden, aux):
    """The encoder's ELK block under cos_x, where coords / stride feed the
    positional map, at stride 2 through each aux path, against the JAX
    block with the same weights; and the normalisation changes the
    output."""
    f, c, n = golden[:3]
    rng = np.random.default_rng(1)
    cap, inc = GOLDEN_CAPS[0], 16
    coarse = np.unique(np.concatenate([c[:n, :3] // 2 * 2, c[:n, 3:]], 1),
                       axis=0)
    coarse = coarse[np.lexsort(coarse.T)]       # key order (b, z, y, x)
    m = len(coarse)
    cc = np.full((cap, 4), -(2**20), np.int32)
    cc[:m] = coarse
    feats = rng.standard_normal((cap, inc)).astype(np.float32)
    ext = _extent(c, n) if aux == "dense" else None
    jmod = JELKBlock(inc=inc, aux_capacity=cap, groups=1, baseop="cos_x",
                     normalize_coords=True)
    jst = j_make(feats, cc, nnz=m, stride=2, base_sorted=True,
                 grid_extent=ext)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(2), jst, 10, 3)["params"])
    params["alpha"] = rng.uniform(0.5, 1.5, params["alpha"].shape).astype(
        np.float32)
    want = np.asarray(jmod.apply({"params": params}, jst, 10, 3).feats)[:m]

    block = ELKBlock(inc, aux_capacity=cap, groups=1, baseop="cos_x",
                     normalize_coords=True, device="cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    block.load_state_dict({
        "pre_mix.0.weight": t(params["pre_mix"]["kernel"].T),
        "pre_mix.1.weight": t(params["pre_mix_norm"]["scale"]),
        "pre_mix.1.bias": t(params["pre_mix_norm"]["bias"]),
        "local_mix.0.kernel": t(params["local_mix"]["kernel"]),
        "pos_weight.0.weight": t(params["pos_weight"]["kernel"].T),
        "alpha": t(params["alpha"]),
        "norm.weight": t(params["norm"]["scale"]),
        "norm.bias": t(params["norm"]["bias"]),
        "norm_local.weight": t(params["norm_local"]["scale"]),
        "norm_local.bias": t(params["norm_local"]["bias"])}, strict=True)
    st = t_make(feats, cc, nnz=m, stride=2, base_sorted=True,
                grid_extent=ext, device="cpu")
    assert (use_dense_aux(st, 10, 3, 3 * inc) is not None) == (aux == "dense")
    with torch.inference_mode():
        got = block(st, 10, 3).feats.numpy()[:m]
        block.normalize_coords = False
        raw = block(t_make(feats, cc, nnz=m, stride=2, base_sorted=True,
                           grid_extent=ext, device="cpu"), 10, 3).feats
    assert _rel(got, want) < 1e-5
    assert _rel(raw.numpy()[:m], want) > 1e-2


def test_bfloat16_forward_stays_near_float32(golden):
    """bfloat16 runs the same graph with 8-bit mantissas: finite logits
    within 5% of the float32 ones (relative to their largest magnitude)."""
    f, c, n, _, sd = golden
    ref = _port_logits(_port(sd), f, c, n)
    got = _port_logits(_port(sd, "bfloat16"), f, c, n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) < 5e-2
