"""The port's slice end to end: ELKUNet vs the reference goldens and vs the
JAX ELKUNet, parameter conversion, the input pipeline, and the import wall
between the two packages.

Logits are compared as max|port - ref| / max|ref| < 2e-4, the bound of the
JAX package's own golden tests: float32 throughout, the sums of ~30 layers
taken in another order. The JAX forward is compiled once per module (one
jitted apply, shared by every test that calls it).
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from link_tpu.data import collate as jcollate
from link_tpu.data import semantic_kitti as jkitti
from link_tpu.models.linkunet import ELKUNet as JELKUNet
from link_tpu.nn.modules import SparseBatchNorm as JBatchNorm
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.torch_import import translate_elkunet
from link_tpu_torch.data import collate as tcollate
from link_tpu_torch.data import semantic_kitti as tkitti
from link_tpu_torch.models.linkunet import ELKUNet as TELKUNet
from link_tpu_torch.nn.modules import SparseBatchNorm as TBatchNorm
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils.convert import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
STATE = os.path.join(GOLDEN_DIR, "elkunet_cr0.25_state.npz")
SCANS = sorted(glob.glob(os.path.join(GOLDEN_DIR, "elkunet_cr0.25_[0-9].npz")))
# as tests/test_golden_parity.py: the level-1 cap of 640 keeps every
# stride-2 cell of these ~590-voxel clouds
GOLDEN_CAPS = (1024, 640, 256, 128, 64)
TOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _padded(path):
    g = np.load(path)
    n, cap = len(g["coords"]), GOLDEN_CAPS[0]
    c = np.full((cap, 4), -(2**20), np.int32)
    f = np.zeros((cap, 4), np.float32)
    c[:n], f[:n] = g["coords"], g["feats"]
    return f, c, n, g["logits"]


def _state():
    return {k: torch.from_numpy(np.array(v)) for k, v in np.load(STATE).items()}


def _port(sd, dtype="float32"):
    model = TELKUNet(20, cr=0.25, capacities=GOLDEN_CAPS, dtype=dtype,
                     device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _port_logits(model, f, c, n):
    with torch.inference_mode():
        return model(t_make(f, c, nnz=n, device="cpu")).float().numpy()[:n]


@pytest.fixture(scope="module")
def jax_forward():
    """One jitted JAX ELKUNet forward at cr0.25 / GOLDEN_CAPS."""
    model = JELKUNet(num_classes=20, cr=0.25, capacities=GOLDEN_CAPS)
    return jax.jit(lambda v, f, c, n: model.apply(
        v, j_make(f, c, nnz=n), False))


@pytest.fixture(scope="module")
def scan0():
    return _padded(SCANS[0])


def test_state_dict_matches_reference_keys():
    ref = np.load(STATE)
    port = TELKUNet(20, cr=0.25, capacities=GOLDEN_CAPS, device="cpu")
    sd = port.state_dict()
    assert sorted(sd) == sorted(ref.files) and len(sd) == 366
    for k in ref.files:
        assert tuple(sd[k].shape) == ref[k].shape, k


@pytest.mark.parametrize("path", SCANS, ids=os.path.basename)
def test_port_matches_reference_goldens(path):
    f, c, n, want = _padded(path)
    got = _port_logits(_port(_state()), f, c, n)
    assert _rel(got, want) < TOL


def test_port_matches_jax_elkunet(jax_forward, scan0):
    f, c, n, _ = scan0
    tr = translate_elkunet(dict(np.load(STATE)))
    want = np.asarray(jax_forward(tr, f, c, n))[:n]
    got = _port_logits(_port(_state()), f, c, n)
    assert _rel(got, want) < TOL


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's own init at cr0.25 (parameters do not depend on the
    capacities, so a tiny input suffices), batch stats perturbed by numpy."""
    model = JELKUNet(num_classes=20, cr=0.25, capacities=(64,) * 5)
    c = np.full((64, 4), -(2**20), np.int32)
    c[:8] = [[i % 3, i // 3 % 3, i // 2, 0] for i in range(8)]
    v = jax.jit(lambda k, f, c: model.init(k, j_make(f, c, nnz=8), False))(
        jax.random.PRNGKey(3), np.zeros((64, 4), np.float32), c)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(-0.2, 0.2, a.shape).astype(
            np.float32) if a.ndim else np.asarray(a), v["batch_stats"])
    return params, stats


def test_from_jax_params_round_trip_is_exact(jax_init):
    params, stats = jax_init
    back = translate_elkunet({k: v.numpy() for k, v in
                              from_jax_params(params, stats).items()})
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back["params"])
    assert [p for p, _ in flat_p] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))
    got_s = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(back["batch_stats"])}
    for p, a in jax.tree_util.tree_leaves_with_path(stats):
        np.testing.assert_array_equal(got_s[jax.tree_util.keystr(p)], a)


def test_from_jax_params_gives_the_jax_logits(jax_forward, jax_init, scan0):
    params, stats = jax_init
    f, c, n, _ = scan0
    sd = from_jax_params(params, stats)
    # translate_elkunet lays the trees out as the golden run does, so the
    # jitted forward is reused without another compile
    want = np.asarray(jax_forward(translate_elkunet(
        {k: v.numpy() for k, v in sd.items()}), f, c, n))[:n]
    got = _port_logits(_port(sd), f, c, n)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel(got, want) < TOL


def test_bfloat16_forward_stays_near_float32(scan0):
    """bfloat16 runs the same graph with 8-bit mantissas: finite logits
    within 5% of the float32 ones (relative to their largest magnitude)."""
    f, c, n, _ = scan0
    sd = _state()
    ref = _port_logits(_port(sd), f, c, n)
    got = _port_logits(_port(sd, "bfloat16"), f, c, n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) < 5e-2


@pytest.mark.parametrize("train", [True, False])
def test_sparse_batchnorm_matches_jax(train):
    rng = np.random.default_rng(8)
    c = np.full((50, 4), -(2**20), np.int32)
    c[:37] = np.stack([np.arange(37), np.zeros(37), np.zeros(37),
                       np.zeros(37)], 1)
    f = rng.standard_normal((50, 6)).astype(np.float32) * 3 + 1
    scale, bias = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32)
    mean, var = rng.random(6).astype(np.float32), 1 + rng.random(6).astype(np.float32)
    out, upd = JBatchNorm(6).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        j_make(f, c, nnz=37), train, mutable=["batch_stats"])
    bn = TBatchNorm(6, device="cpu")
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train(train)
    got = bn(t_make(f, c, nnz=37, device="cpu")).feats.detach().numpy()
    assert _rel(got[:37], np.asarray(out.feats)[:37]) < 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               upd["batch_stats"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               upd["batch_stats"]["var"], rtol=1e-5)
    assert int(bn.num_batches_tracked) == int(train)


def test_synthetic_scans_and_collate_match_jax_package():
    kw = dict(length=2, num_points=900, n_raw_points=3000, split="train",
              seed=4)
    jds, tds = jkitti.SyntheticSemanticKITTI(**kw), tkitti.SyntheticSemanticKITTI(**kw)
    jscans, tscans = [jds[i] for i in range(2)], [tds[i] for i in range(2)]
    for a, b in zip(jscans, tscans):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    ext = tkitti.grid_extent(0.05, 2)
    assert ext == jkitti.grid_extent(0.05, 2) == (3584, 3584, 448, 2)
    jb = jcollate.collate_scans(jscans, 2048, point_capacity=8000,
                                grid_extent=ext)
    tb = tcollate.collate_scans(tscans, 2048, point_capacity=8000,
                                grid_extent=ext)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    st = tcollate.to_sparse_tensor(tb, device="cpu", grid_extent=ext)
    assert st.coords_sorted and st.base_sorted and st.grid_extent == ext
    assert int(st.nnz) == int(tb["nnz"]) and st.capacity == 2048


def test_port_imports_neither_jax_nor_link_tpu():
    """Import every module of the port in a fresh interpreter and inspect
    sys.modules."""
    code = (
        "import pkgutil, importlib, sys, link_tpu_torch\n"
        "for m in pkgutil.walk_packages(link_tpu_torch.__path__, "
        "'link_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'link_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('link_tpu_torch.')]))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert int(out.stdout.strip().splitlines()[-1]) >= 15
    smoke = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; runpy.run_path('chip_smoke.py', run_name='x');"
         "bad = [n for n in sys.modules if n.split('.')[0] in "
         "('jax', 'link_tpu')]; sys.exit(str(bad) if bad else 0)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert smoke.returncode == 0, smoke.stderr + smoke.stdout
    # and no import statement of either, anywhere in the port's sources
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|link_tpu)\b(?!_)",
                     re.M)
    files = glob.glob(os.path.join(REPO, "link_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
