"""Port vs JAX and the reference goldens: the CenterPoint-ELKv3 detector.

- RPN + CenterHead with the reference weights of tests/goldens/det_dense.npz
  against its RPN output and head maps: rel < 1e-5, the bound of
  tests/test_golden_det_dense.py (float32 convs, another summation order).
- `from_jax_det_params` against `translate_voxelnet`: exact both ways.
- A tiny VoxelNet (grid (48, 48, 40), capacities (4096, 2048, 1024, 512), as
  tests/test_voxelnet.py) against the JAX VoxelNet with shared weights, in
  float32: every head map at rel < 2e-4 (max|port - ref| / max|ref|, the
  bound of the JAX package's golden tests; measured ~3e-6), and the same
  window-form or gather-form choice for every conv, in order.
- The same port model in bfloat16 against its float32 self: rel < 5e-2
  (8-bit mantissas through ~40 layers; level 0 only runs in bf16).
"""

import os

import numpy as np
import pytest
import torch

import jax

from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.sparse import conv as jconv
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.center_head import CenterHead
from link_tpu_torch.models.rpn import RPN
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.utils.convert import from_jax_det_params

from test_torch_import_det import make_det_state_dict

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "det_dense.npz")
GRID = (48, 48, 40)
CAPS = (4096, 2048, 1024, 512)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    sd = {k[3:].replace("__", "."): torch.from_numpy(np.array(z[k]))
          for k in z.files if k.startswith("sd_")}
    return z, sd


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_rpn_matches_det_dense_golden(golden):
    z, sd = golden
    neck = RPN(device="cpu")
    neck.load_state_dict(_sub(sd, "neck."), strict=True)
    neck.eval()
    with torch.inference_mode():
        out = neck(torch.from_numpy(z["bev"]))
    assert out.shape == (1, 512, 40, 40)
    assert _rel(out.numpy(), z["rpn_out"]) < 1e-5


def test_center_head_matches_det_dense_golden(golden):
    z, sd = golden
    head = CenterHead(device="cpu")
    head.load_state_dict(_sub(sd, "bbox_head."), strict=True)
    head.eval()
    with torch.inference_mode():
        preds = head(torch.from_numpy(z["rpn_out"]))
    assert len(preds) == 6
    for t, pd in enumerate(preds):
        assert list(pd) == ["reg", "height", "dim", "rot", "vel", "hm"]
        for name, v in pd.items():
            want = z[f"task{t}_{name}"]                    # torch NCHW
            assert _rel(v.permute(0, 3, 1, 2).numpy(), want) < 1e-5, (t, name)


def _reference_sd():
    """A reference-keyed det3d state_dict (the structure test's emulation)
    with nudged BN statistics and biases, plus BatchNorm's counters."""
    sd = make_det_state_dict()
    rng = np.random.default_rng(5)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = rng.uniform(-0.2, 0.2, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32)
        elif k.endswith(".bias"):
            sd[k] = rng.uniform(-0.1, 0.1, sd[k].shape).astype(np.float32)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = np.int64(0)
    return sd


def _torch_sd(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def test_state_dict_matches_reference_keys():
    sd = _reference_sd()
    port = TVoxelNet(capacities=CAPS, grid_shape=GRID, device="cpu")
    got = port.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert tuple(got[k].shape) == np.shape(v), k
    port.load_state_dict(_torch_sd(sd), strict=True)


def test_from_jax_det_params_round_trip_is_exact():
    sd = _reference_sd()
    tr = translate_voxelnet(sd)
    back = from_jax_det_params(tr["params"], tr["batch_stats"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), k)
    tr2 = translate_voxelnet({k: v.numpy() for k, v in back.items()})
    for tree in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(tr[tree])
        b = jax.tree_util.tree_leaves_with_path(tr2[tree])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          str(p))


def _tiny_batch():
    """tests/test_voxelnet.py's tiny sample: 3000 points over a 48 x 48 x 40
    grid, voxelized and collated by the port."""
    rng = np.random.default_rng(50)
    pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
    pts[:, 4] = 0
    v, c, n = tdp.points_to_voxel(pts, (0.5, 0.5, 0.1),
                                  (-12, -12, -2, 12, 12, 2), max_points=5,
                                  max_voxels=4000)
    return tdp.collate_det([{"voxels": v, "coords_zyx": c, "num_points": n}],
                           CAPS[0], max_points=5)


def _port_preds(sd, batch, dtype="float32", calls=None):
    model = TVoxelNet(capacities=CAPS, grid_shape=GRID, dtype=dtype,
                      device="cpu")
    model.load_state_dict(_torch_sd(sd), strict=True)
    model.eval()
    orig = (tk.window_conv, tk.gather_conv)

    def spy(kind, fn):
        def wrapped(feats, *a):
            if calls is not None:
                calls.append((kind, feats.shape[1], a[-1].shape[2]))
            return fn(feats, *a)
        return wrapped

    try:
        tk.window_conv = spy("window", orig[0])
        tk.gather_conv = spy("gather", orig[1])
        with torch.inference_mode():
            return model(*tdp.det_inputs(batch, "cpu"))
    finally:
        tk.window_conv, tk.gather_conv = orig


def test_voxelnet_matches_jax_voxelnet(monkeypatch):
    sd = _reference_sd()
    batch = _tiny_batch()
    assert int(batch["nnz"]) > 2000
    jcalls = []
    win, gm = jconv._win_apply_impl, jconv._gm_impl

    def j_win(feats, weight, *a):
        jcalls.append(("window", feats.shape[1], weight.shape[2]))
        return win(feats, weight, *a)

    def j_gm(feats, weight, idx):
        jcalls.append(("gather", feats.shape[1], weight.shape[2]))
        return gm(feats, weight, idx)

    monkeypatch.setattr(jconv, "_win_apply_impl", j_win)
    monkeypatch.setattr(jconv, "_gm_impl", j_gm)
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=CAPS)
    want = jax.jit(lambda v, *a: model.apply(v, *a, False))(
        translate_voxelnet(sd), batch["voxels"], batch["coords"],
        batch["num_points"], batch["nnz"])
    tcalls = []
    got = _port_preds(sd, batch, calls=tcalls)
    assert len(got) == len(want) == 6
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)      # jit returns sorted dicts
        for k in w:
            assert g[k].shape == w[k].shape == (1, 6, 6, w[k].shape[-1])
            assert _rel(g[k].numpy(), w[k]) < 2e-4, (t, k)
    # 33 sparse convs with K > 1; level 0 (16 channels) takes the window
    # form, the wider levels the gather form, in both packages
    assert tcalls == jcalls and len(tcalls) == 33
    assert sum(kind == "window" for kind, _, _ in tcalls) == 7


def test_bfloat16_forward_stays_near_float32():
    sd = _reference_sd()
    batch = _tiny_batch()
    ref = _port_preds(sd, batch)
    got = _port_preds(sd, batch, "bfloat16")
    for g, r in zip(got, ref):
        for k in r:
            assert g[k].dtype == torch.bfloat16
            assert torch.isfinite(g[k].float()).all()
            assert _rel(g[k].float().numpy(), r[k].numpy()) < 5e-2, k
