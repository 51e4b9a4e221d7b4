"""Port vs JAX: the DCN head (`models/dcn.py`, `CenterHead(dcn_head=True)`).

The same numpy inputs and weights go through `link_tpu.models.dcn` (eager
JAX) and `link_tpu_torch.models.dcn`; the flax trees reach the port through
`utils.convert.from_jax_center_head`. Bounds:
  * float32 forwards: 1e-5 of the output's largest magnitude (measured
    ~2e-7; the same samples summed in another order);
  * bfloat16: `deform_conv2d` 8e-3 (the bound of the port's bf16 conv
    tests; measured 0); the whole bf16 head's maps 4e-2, the head bound of
    tests/test_torch_bf16.py (measured 1e-2: five bf16 convs and BNs deep,
    rounded at other points than XLA rounds them);
  * the gradients of x, the offsets and the weight of `deform_conv2d`, and
    of a FeatureAdaption's parameters, against `jax.vjp` / `jax.grad`:
    1e-5 of each gradient's largest magnitude. The offsets' gradients come
    through the bilinear weights in both packages.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.models import dcn as J
from link_tpu.models.center_head import CenterHead as JCenterHead
from link_tpu_torch.models import dcn as T
from link_tpu_torch.models.center_head import CenterHead as TCenterHead
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.utils.convert import from_jax_center_head

from test_torch_det_test_tool import tiny, tree  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

F32 = 1e-5
BF16 = 8e-3
BF16_HEAD = 4e-2
TASKS = (("car",), ("bus", "trailer"))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _inputs(seed, b=2, h=7, w=6, c=8, g=2, co=5, ks=3, span=2.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    # offsets reaching in-map, sub-pixel and off-map samples
    off = rng.uniform(-span, span, (b, h, w, g * ks * ks * 2)).astype(
        np.float32)
    wgt = (rng.normal(size=(ks * ks, c, co)) * 0.3).astype(np.float32)
    return x, off, wgt


@pytest.mark.parametrize("g,span,shape", [(2, 2.5, (2, 7, 6, 8)),
                                          (4, 0.4, (1, 9, 9, 8)),
                                          (1, 6.0, (1, 5, 11, 4))])
def test_deform_conv2d_matches_jax(g, span, shape):
    b, h, w, c = shape
    x, off, wgt = _inputs(0, b, h, w, c, g, span=span)
    want = J.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt),
                           kernel_size=3, deformable_groups=g)
    got = T.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                          torch.from_numpy(wgt), 3, g)
    assert got.shape == (b, h, w, 5)
    assert _rel(got.numpy(), want) < F32


def test_deform_conv2d_in_bfloat16_matches_jax():
    x, off, wgt = _inputs(1)
    want = J.deform_conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(off),
                           jnp.asarray(wgt), kernel_size=3,
                           deformable_groups=2)
    got = T.deform_conv2d(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(off), torch.from_numpy(wgt), 3, 2)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < BF16


def test_deform_conv2d_gradients_match_jax_vjp():
    x, off, wgt = _inputs(2, span=1.5)
    rng = np.random.default_rng(3)
    cot = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, o, w: J.deform_conv2d(
        a, o, w, kernel_size=3, deformable_groups=2),
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt))
    want = vjp(jnp.asarray(cot))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, off, wgt)]
    T.deform_conv2d(*args, 3, 2).backward(torch.from_numpy(cot))
    for name, a, w in zip(("x", "offset", "weight"), args, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        assert _rel(a.grad.numpy(), w) < F32, name


def _adaption(seed, c=8, co=8):
    """A JAX FeatureAdaption's variables with a random offset kernel (its
    init is zero), and the port module holding the same weights."""
    x = np.random.default_rng(seed).normal(size=(1, 8, 8, c)).astype(
        np.float32)
    m = J.FeatureAdaption(co)
    vs = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, vs["params"])
    p["conv_offset"]["kernel"] = (np.random.default_rng(seed + 1).normal(
        size=p["conv_offset"]["kernel"].shape) * 0.1).astype(np.float32)
    port = T.FeatureAdaption(c, co, device="cpu")
    with torch.no_grad():
        port.conv_offset.weight.copy_(torch.from_numpy(
            p["conv_offset"]["kernel"].transpose(3, 2, 0, 1).copy()))
        port.conv_offset.bias.copy_(torch.tensor(p["conv_offset"]["bias"]))
        port.conv_adaption.weight.copy_(torch.from_numpy(
            p["deform_weight"].reshape(3, 3, c, co).transpose(3, 2, 0, 1)
            .copy()))
    return m, p, port, x


def test_feature_adaption_matches_jax_forward_and_gradients():
    m, p, port, x = _adaption(4)
    want = m.apply({"params": p}, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert _rel(got.detach().numpy(), want) < F32

    def loss(params):
        return jnp.sum(m.apply({"params": params}, jnp.asarray(x)) ** 2)

    g = jax.grad(loss)(p)
    got.square().sum().backward()
    pairs = ((port.conv_offset.weight.grad.permute(2, 3, 1, 0),
              g["conv_offset"]["kernel"]),
             (port.conv_offset.bias.grad, g["conv_offset"]["bias"]),
             (port.conv_adaption.weight.grad.permute(2, 3, 1, 0).reshape(
                 9, 8, 8), g["deform_weight"]))
    for a, w in pairs:
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel(a.numpy(), w) < F32


def test_feature_adaption_init():
    """The offset conv's weight zero and bias within +-1/sqrt(fan_in) (the
    reference's init_offset and torch's default), as JAX's init."""
    port = T.FeatureAdaption(16, 16, device="cpu")
    port.reset_parameters(torch.Generator().manual_seed(0))
    assert not port.conv_offset.weight.any()
    b = port.conv_offset.bias
    assert b.abs().max() <= 0.25 and b.any()
    assert port.conv_adaption.weight.shape == (16, 16, 3, 3)


def _nudged(vs, seed):
    """The JAX head's variables with nudged BN statistics and biases and a
    random offset kernel, as numpy trees."""
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        a = np.asarray(a).copy()
        name = jax.tree_util.keystr(path)
        if "mean" in name or "bias" in name:
            a = a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        elif "var" in name:
            a = a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        elif "conv_offset" in name and "kernel" in name:
            a = (rng.normal(size=a.shape) * 0.05).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(nudge, vs)


@pytest.fixture(scope="module")
def heads():
    x = np.random.default_rng(5).normal(size=(2, 32, 8, 8)).astype(
        np.float32)
    jm = JCenterHead(in_channels=32, tasks=TASKS, dcn_head=True)
    vs = _nudged(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 6)
    sd = from_jax_center_head(vs["params"], vs["batch_stats"])
    return jm, vs, sd, x


@pytest.mark.parametrize("train", [False, True])
def test_center_head_with_dcn_matches_jax(heads, train):
    jm, vs, sd, x = heads
    port = TCenterHead(in_channels=32, tasks=TASKS, dcn_head=True,
                       device="cpu")
    port.load_state_dict(sd, strict=True)
    port.train(train)
    if train:
        want, upd = jm.apply(vs, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(vs, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 2
    for t, (g, w) in enumerate(zip(got, want)):
        assert list(g) == ["reg", "height", "dim", "rot", "vel", "hm"]
        for k in w:
            assert g[k].shape == w[k].shape, (t, k)
            assert _rel(g[k].numpy(), w[k]) < F32, (t, k)
    if train:
        ref = from_jax_center_head(vs["params"], upd["batch_stats"])
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert _rel(v.numpy(), ref[k].numpy()) < F32, k


def test_center_head_with_dcn_in_bfloat16_matches_jax(heads):
    _, vs, sd, x = heads
    jm = JCenterHead(in_channels=32, tasks=TASKS, dcn_head=True,
                     dtype="bfloat16")
    port = TCenterHead(in_channels=32, tasks=TASKS, dcn_head=True,
                       dtype="bfloat16", device="cpu")
    port.load_state_dict(sd, strict=True)
    port.eval()
    want = jm.apply(vs, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        for k in w:
            err = _rel(g[k].float().numpy(), np.asarray(w[k], np.float32))
            assert err < BF16_HEAD, (k, err)


def test_voxelnet_with_dcn_head_has_the_reference_keys():
    """The DCN head's state_dict keys are det3d's (center_head.py:27-162),
    the seeded init keeps the offset weights zero and hm's bias -2.19."""
    m = TVoxelNet(grid_shape=(48, 48, 40), capacities=(1024,) * 4,
                  dcn_head=True, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    sd = m.state_dict()
    pre = "bbox_head.tasks.0."
    for key in ("feature_adapt_cls.conv_offset.weight",
                "feature_adapt_cls.conv_offset.bias",
                "feature_adapt_cls.conv_adaption.weight",
                "feature_adapt_reg.conv_adaption.weight",
                "cls_head.0.weight", "cls_head.1.running_var",
                "cls_head.3.bias", "task_head.reg.0.weight",
                "task_head.vel.3.bias"):
        assert pre + key in sd, key
    assert not any(".hm." in k for k in sd)
    assert sd[pre + "feature_adapt_cls.conv_adaption.weight"].shape == (
        64, 64, 3, 3)
    assert not sd[pre + "feature_adapt_reg.conv_offset.weight"].any()
    assert torch.all(sd[pre + "cls_head.3.bias"] == -2.19)


# ---------------------------------------------------------------------------
# det_test with the DCN head, at the tests' tiny grid


def _dcn_tasks_to_jax(sd, n_tasks):
    """The port's DCN task heads (reference keys) -> the JAX CenterHead's
    `task<t>_dcn` params and batch_stats (the inverse of
    `from_jax_center_head`'s DCN part)."""
    from link_tpu.utils.torch_import_det import conv2d_to_flax

    def a(key):
        return sd[key].numpy()

    def bn(pre):
        return ({"scale": a(f"{pre}.weight"), "bias": a(f"{pre}.bias")},
                {"mean": a(f"{pre}.running_mean"),
                 "var": a(f"{pre}.running_var")})

    def conv(pre):
        return {"kernel": conv2d_to_flax(a(f"{pre}.weight")),
                "bias": a(f"{pre}.bias")}

    params, stats = {}, {}
    for t in range(n_tasks):
        pre = f"bbox_head.tasks.{t}"
        p, s = {}, {}
        for fa in ("feature_adapt_cls", "feature_adapt_reg"):
            w = a(f"{pre}.{fa}.conv_adaption.weight")        # (Co, Ci, 3, 3)
            p[fa] = {"conv_offset": conv(f"{pre}.{fa}.conv_offset"),
                     "deform_weight": w.transpose(2, 3, 1, 0).reshape(
                         9, w.shape[1], w.shape[0])}
        p["cls0"], p["cls1"] = conv(f"{pre}.cls_head.0"), \
            conv(f"{pre}.cls_head.3")
        p["cls_bn"], s["cls_bn"] = bn(f"{pre}.cls_head.1")
        for head in ("reg", "height", "dim", "rot", "vel"):
            b = f"{pre}.task_head.{head}"
            p[head] = {"conv0": conv(f"{b}.0"), "final": conv(f"{b}.3")}
            p[head]["bn0"], bs = bn(f"{b}.1")
            s[head] = {"bn0": bs}
        params[f"task{t}_dcn"], stats[f"task{t}_dcn"] = p, s
    return params, stats


def _jax_variables(model):
    from link_tpu.utils.torch_import_det import translate_voxelnet
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr = translate_voxelnet({k: v.numpy() for k, v in sd.items()
                             if not k.startswith("bbox_head.tasks.")},
                            tasks=())
    p, s = _dcn_tasks_to_jax(sd, len(model.tasks))
    tr["params"]["bbox_head"].update(p)
    tr["batch_stats"]["bbox_head"].update(s)
    return tr


@pytest.fixture(scope="module")
def jax_dcn_voxelnet():
    from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
    from test_torch_det_test_tool import GRID
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=det_capacities(4096, 1), dcn_head=True)
    return jax.jit(lambda v, *a: model.apply(v, *a, False))


@pytest.mark.parametrize("how", ["--dcn-head", "config"])
def test_det_test_with_the_dcn_head_matches_jax(tree, tiny, tmp_path, how,
                                                jax_dcn_voxelnet):
    """det_test with the DCN head chosen by --dcn-head or by a config's
    bbox_head.dcn_head: its model's head maps against the jitted JAX
    VoxelNet(dcn_head=True) on each frame's batch with the same weights
    (rel 2e-4, the tiny VoxelNet's bound in tests/test_torch_det_model.py),
    and its records those of the model's own decode and NMS."""
    from link_tpu_torch.data import det_pipeline as tdp
    from link_tpu_torch.inference import masked_rows
    from link_tpu_torch.models.dcn import DCNSepHead
    from link_tpu_torch.tools import det_test
    if how == "config":
        cfg = tmp_path / "dcn.py"
        base = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "nusc", "voxelnet", "nusc_centerpoint_voxelnet_"
                            "0075voxel_fix_bn_z_elkv3.py")
        cfg.write_text(open(base).read()
                       + "\nmodel['bbox_head']['dcn_head'] = True\n")
        flags = ["--config", str(cfg)]
    else:
        flags = ["--dcn-head"]
    flags = ["--info-path", tree[1]["val"], "--root-path", tree[0],
             "--device", "cpu", *flags]
    r = det_test.evaluate(det_test.parse_args(flags))
    assert len(r["samples"]) == 2
    run = det_test.DetTest(det_test.parse_args(flags), "cpu")
    assert all(isinstance(t, DCNSepHead) for t in run.model.bbox_head.tasks)
    variables = _jax_variables(run.model)
    ds = det_test.make_dataset(det_test.parse_args(flags))
    for i, rec in enumerate(r["samples"]):
        batch = run.batch(ds[i])
        with torch.no_grad():
            preds = run.model(*tdp.det_inputs(batch, "cpu"))
        want = jax_dcn_voxelnet(variables, batch["voxels"], batch["coords"],
                                batch["num_points"], batch["nnz"])
        for g, w in zip(preds, want):
            for k in w:
                assert _rel(g[k].numpy(), w[k]) < 2e-4, k
        for got, key in zip(run.detections(masked_rows(run.forward(batch))),
                            ("pred_boxes", "pred_scores", "pred_labels")):
            np.testing.assert_array_equal(rec[key], got)
        assert np.isfinite(rec["pred_boxes"]).all()
