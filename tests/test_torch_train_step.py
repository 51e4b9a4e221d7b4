"""The port's seg training step against the JAX package's, and its training
dynamics against the reference's recorded curve.

A small ELKUNet (cr 0.125, capacities (384, 192, 96, 48, 24), as
tests/test_remat_policy.py sizes it) with shared weights: the port's seeded
init, carried to the JAX trees by `translate_elkunet`. One jitted JAX step
serves the whole file; it returns the gradients beside what
`link_tpu.train.trainer.seg_train_step` returns. Inputs are synthetic scans
made with numpy, two per batch.

Tolerances (float32 on both sides, ~60 layers, sums in another order):
  * losses at a step that starts from equal weights: 1e-4 absolute;
  * each gradient leaf: 1e-3 of the leaf's largest magnitude. The backward
    of ~25 masked BatchNorms divides by small variances at this width, which
    amplifies the forward's 1e-6 differences;
  * parameters and batch statistics after one step: 1e-5 of the tensor's
    largest magnitude plus lr * the gradient bound;
  * over three steps: each step's losses 1e-4 absolute and the batch
    statistics 1e-3 of the largest magnitude (both depend on the forward
    only). The parameters are held as a whole, relative L2 distance 5e-3:
    at this width some BatchNorm channels are nearly constant, their
    normalized values are float noise around zero, and the ReLU behind them
    takes another side in the two frameworks. The loss is the same to first
    order and a finite difference lies between the two gradients, so single
    leaves can differ by percents after a few steps without either side
    being wrong. The seeds below give a first step without such a channel;
  * the optimizer alone (fed the same gradients): 1e-6 relative.
The 40-step replay of tests/goldens/train_ab.npz and its bounds are those of
tests/test_convergence_ab.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from link_tpu.models.linkunet import ELKUNet as JELKUNet
from link_tpu.nn.modules import SparseBatchNorm as JBatchNorm
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.train import losses as JL
from link_tpu.train import schedules as JS
from link_tpu.train import trainer as JT
from link_tpu.utils.torch_import import translate_elkunet
from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models.linkunet import ELKUNet as TELKUNet
from link_tpu_torch.nn.modules import SparseBatchNorm as TBatchNorm
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.train import trainer as TT
from link_tpu_torch.utils.convert import to_jax_flat
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = (384, 192, 96, 48, 24)
CR = 0.125
SCHEDULE = (0.05, 2, 2, 8)     # base lr, epochs, batch, dataset size
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "train_ab.npz")
GOLDEN_CAPS = (1024, 640, 256, 128, 64)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _batches(n=2, seed=11):
    ds = SyntheticSemanticKITTI(length=2 * n, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=seed)
    return [collate_scans([ds[2 * i], ds[2 * i + 1]], CAPS[0])
            for i in range(n)]


def _port_model(seed=0):
    return TELKUNet(20, cr=CR, capacities=CAPS, device="cpu",
                    generator=torch.Generator().manual_seed(seed))


def _flat(tree, coll):
    return {coll + "/" + "/".join(k.key for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_step():
    """(jitted step, fresh state maker). step(state, batch) -> (new state,
    metrics, gradients)."""
    model = JELKUNet(num_classes=20, cr=CR, capacities=CAPS)
    tx = JT.make_sgd(JS.cosine_warmup(*SCHEDULE), momentum=0.9,
                     weight_decay=1e-4, nesterov=True)

    def step(state, batch):
        def loss_fn(params):
            st = j_make(batch["feats"], batch["coords"], nnz=batch["nnz"],
                        base_sorted=True)
            logits, _ = model.apply(
                {"params": params, "batch_stats": state.batch_stats}, st,
                True, mutable=["batch_stats"])
            valid = jnp.arange(logits.shape[0]) < batch["nnz"]
            return JL.segmentation_loss(logits, batch["labels"], valid, 0)[0]

        grads = jax.grad(loss_fn)(state.params)
        new_state, metrics = JT.seg_train_step(model, tx, state, batch)
        return new_state, metrics, grads

    def make_state(port_model):
        # copies: JAX may alias a numpy buffer on the CPU, and the port's
        # optimizer updates its parameters in place
        v = translate_elkunet({k: t.detach().clone().numpy() for k, t in
                               port_model.state_dict().items()})
        return JT.TrainState(step=jnp.int32(0), params=v["params"],
                             batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]))

    return jax.jit(step), make_state


def _jbatch(b):
    return {k: jnp.asarray(b[k]) for k in ("feats", "coords", "labels", "nnz")}


@pytest.fixture(scope="module")
def one_step(jax_step):
    """One step of both packages from the same weights on the same batch."""
    step, make_state = jax_step
    port = _port_model()
    state = make_state(port)
    b = _batches(1)[0]
    new_state, jm, jgrads = step(state, _jbatch(b))
    opt = TT.make_sgd(port.parameters(), 1.0)
    lr = TS.cosine_warmup(*SCHEDULE)
    tm = TT.seg_train_step(port, opt, b, ignore_label=0, lr=lr(0))
    tgrads = {k: p.grad for k, p in port.named_parameters()}
    return port, tm, tgrads, new_state, jm, jgrads, lr(0)


def test_train_step_loss_parts_match_jax(one_step):
    _, tm, _, _, jm, _, _ = one_step
    assert sorted(tm) == sorted(jm) == ["loss", "loss_ce", "loss_lovasz"]
    for k in tm:
        assert tm[k].dim() == 0 and not tm[k].requires_grad
        assert abs(float(tm[k]) - float(jm[k])) < 1e-4, k


def test_every_gradient_leaf_matches_jax(one_step):
    _, _, tgrads, _, _, jgrads, _ = one_step
    want = _flat(jgrads, "params")
    got = to_jax_flat(tgrads)
    assert sorted(got) == sorted(want) and len(got) > 100
    worst = max(got, key=lambda k: _rel(got[k], want[k]))
    assert all(np.abs(w).max() > 0 for w in want.values())
    assert _rel(got[worst], want[worst]) < 1e-3, worst


def test_parameters_and_batch_stats_after_one_step_match_jax(one_step):
    port, _, _, new_state, _, _, lr = one_step
    want = {**_flat(new_state.params, "params"),
            **_flat(new_state.batch_stats, "batch_stats")}
    got = to_jax_flat(port.state_dict())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        bound = 1e-5 * np.abs(w).max() + 1.9 * lr * 1e-3 * np.abs(w).max()
        assert np.abs(got[k] - w).max() <= bound + 1e-7, k
    moved = [k for k in want if k.startswith("batch_stats/")
             and k.endswith("/mean") and np.abs(want[k]).max() > 0]
    assert len(moved) > 20          # the running statistics did move


def test_remat_step_matches_jax(jax_step):
    """The rematerialized ELKUNet (`remat=True`, seg_train's model) against
    the same jitted JAX step (the JAX model without remat, which
    tests/test_remat_policy.py holds equal to its remat model): the losses
    and every gradient leaf to the bounds above."""
    step, make_state = jax_step
    port = TELKUNet(20, cr=CR, capacities=CAPS, remat=True, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    b = _batches(1)[0]
    _, jm, jgrads = step(make_state(port), _jbatch(b))
    opt = TT.make_sgd(port.parameters(), 1.0)
    tm = TT.seg_train_step(port, opt, b, lr=TS.cosine_warmup(*SCHEDULE)(0))
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) < 1e-4, k
    want = _flat(jgrads, "params")
    got = to_jax_flat({k: p.grad for k, p in port.named_parameters()})
    assert sorted(got) == sorted(want)
    worst = max(got, key=lambda k: _rel(got[k], want[k]))
    assert _rel(got[worst], want[worst]) < 1e-3, worst


def test_three_steps_match_jax(jax_step):
    step, make_state = jax_step
    port = _port_model()
    state = make_state(port)
    batches = _batches(2)
    opt = TT.make_sgd(port.parameters(), 1.0)
    lr = TS.cosine_warmup(*SCHEDULE)
    for it in range(3):
        b = batches[it % 2]
        state, jm, _ = step(state, _jbatch(b))
        tm = TT.seg_train_step(port, opt, b, lr=lr(it))
        for k in tm:
            assert abs(float(tm[k]) - float(jm[k])) < 1e-4, (it, k)
    assert int(state.step) == 3
    want = {**_flat(state.params, "params"),
            **_flat(state.batch_stats, "batch_stats")}
    got = to_jax_flat(port.state_dict())
    num = den = 0.0
    for k, w in want.items():
        if k.startswith("batch_stats/"):
            assert np.abs(got[k] - w).max() <= 1e-3 * np.abs(w).max(), k
        else:
            num += float(np.square(got[k] - w).sum())
            den += float(np.square(w).sum())
    assert (num / den) ** 0.5 < 5e-3
    assert all(int(m.num_batches_tracked) == 3 for m in port.modules()
               if isinstance(m, TBatchNorm))


def test_sgd_matches_the_jax_optimizer_on_the_same_gradients():
    """make_sgd (nesterov, coupled weight decay) under the cosine schedule
    against `link_tpu`'s optax chain, four steps on gradients from numpy."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    tx = JT.make_sgd(JS.cosine_warmup(*SCHEDULE), momentum=0.9,
                     weight_decay=1e-4, nesterov=True)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = TT.make_sgd(tp.values(), 1.0, momentum=0.9, weight_decay=1e-4,
                      nesterov=True)
    lr = TS.cosine_warmup(*SCHEDULE)
    for it, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = lr(it)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in p0:
        assert _rel(tp[k].detach().numpy(), np.asarray(jp[k])) < 1e-6, k


def test_sparse_batchnorm_train_mode_matches_jax():
    """Output, gradients through the batch mean and variance, and the
    running statistics (unbiased variance, momentum 0.1)."""
    rng = np.random.default_rng(8)
    n, nnz, c = 50, 37, 6
    coords = np.full((n, 4), -(2**20), np.int32)
    coords[:nnz] = np.stack([np.arange(nnz), np.zeros(nnz), np.zeros(nnz),
                             np.zeros(nnz)], 1)
    f = rng.standard_normal((n, c)).astype(np.float32) * 3 + 1
    cot = rng.standard_normal((n, c)).astype(np.float32)
    scale, bias = (rng.random(c).astype(np.float32) + 0.5,
                   rng.random(c).astype(np.float32))
    mean, var = rng.random(c).astype(np.float32), 1 + rng.random(c).astype(np.float32)

    def jrun(feats, params):
        out, upd = JBatchNorm(c).apply(
            {"params": params, "batch_stats": {"mean": mean, "var": var}},
            j_make(feats, coords, nnz=nnz), True, mutable=["batch_stats"])
        return jnp.sum(out.feats * cot), (out.feats, upd["batch_stats"])

    (_, (jout, jstats)), (jdf, jdp) = jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True)(
            jnp.asarray(f), {"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)})

    bn = TBatchNorm(c, device="cpu")
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    ft = torch.from_numpy(f).requires_grad_()
    out = bn(t_make(ft, coords, nnz=nnz, device="cpu")).feats
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(out.detach().numpy()[:nnz], np.asarray(jout)[:nnz]) < 1e-5
    # 1e-4: the gradient through mean and variance sums ~40 terms that
    # nearly cancel
    assert _rel(ft.grad.numpy(), np.asarray(jdf)) < 1e-4
    assert _rel(bn.weight.grad.numpy(), np.asarray(jdp["scale"])) < 1e-5
    assert _rel(bn.bias.grad.numpy(), np.asarray(jdp["bias"])) < 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"],
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"],
                               rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def _golden_batches(g):
    out = []
    for i in range(int(g["n_scans"])):
        coords, feats, labels = (g[f"scan{i}_coords"], g[f"scan{i}_feats"],
                                 g[f"scan{i}_labels"])
        # rows into pack-key order (b, z, y, x), as the train step assumes
        order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2],
                            coords[:, 3]))
        coords, feats, labels = coords[order], feats[order], labels[order]
        n, cap = len(coords), GOLDEN_CAPS[0]
        cpad = np.full((cap, 4), -(2**20), np.int32)
        fpad = np.zeros((cap, feats.shape[1]), np.float32)
        lpad = np.zeros((cap,), np.int32)
        cpad[:n], fpad[:n], lpad[:n] = coords, feats, labels
        out.append({"feats": fpad, "coords": cpad, "labels": lpad,
                    "nnz": np.int32(n)})
    return out


def test_training_replays_the_reference_curve():
    """The 40 SGD steps of the torch reference (tools/make_goldens_train_ab
    .py) on the port alone, bounds as tests/test_convergence_ab.py:94-107."""
    g = np.load(GOLDEN)
    model = TELKUNet(20, cr=float(g["cr"]), capacities=GOLDEN_CAPS,
                     device="cpu")
    model.load_state_dict({k[3:].replace("__", "."): torch.from_numpy(
        np.array(g[k])) for k in g.files if k.startswith("sd_")}, strict=True)
    batches = _golden_batches(g)
    opt = TT.make_sgd(model.parameters(), float(g["lr"]), momentum=0.9,
                      weight_decay=1e-4, nesterov=True)
    ref = {k: np.asarray(g[k]) for k in ("losses", "ces", "lovs")}
    got = {k: [] for k in ref}
    for it in range(len(ref["losses"])):
        m = TT.seg_train_step(model, opt, batches[it % len(batches)])
        for k, name in (("losses", "loss"), ("ces", "loss_ce"),
                        ("lovs", "loss_lovasz")):
            got[k].append(float(m[name]))
    got = {k: np.asarray(v) for k, v in got.items()}
    for k in ref:                # step 0 is pre-update: forward + loss only
        assert abs(got[k][0] - ref[k][0]) < 2e-3, k
    steps = np.arange(len(ref["losses"]))
    tol = 5e-3 + 0.02 * np.maximum(ref["losses"], 0.2) + 2.5e-3 * steps
    err = np.abs(got["losses"] - ref["losses"])
    assert (err <= tol).all(), (err.max(), err.argmax())
    assert abs(got["losses"][-1] - ref["losses"][-1]) < \
        0.1 + 0.15 * ref["losses"][-1]


def test_seg_loss_decreases_on_two_repeated_scans():
    """As tests/test_training_dynamics.py: 12 steps over two scans."""
    ds = SyntheticSemanticKITTI(length=2, num_points=CAPS[0] - 64,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=3)
    batches = [collate_scans([ds[i]], CAPS[0]) for i in range(2)]
    model = _port_model()
    opt = TT.make_sgd(model.parameters(), 0.02)
    losses = [float(TT.seg_train_step(model, opt, batches[it % 2])["loss"])
              for it in range(12)]
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-2:]) < np.mean(losses[:2]) * 0.8, losses


def test_eval_step_and_train_state_round_trip():
    b = _batches(1)[0]
    model = _port_model()
    opt = TT.make_sgd(model.parameters(), 0.02)
    TT.seg_train_step(model, opt, b)
    preds, counters = TT.seg_eval_step(model, b, 20, 0)
    assert not model.training and preds.shape == (CAPS[0],)
    assert preds.dtype == torch.int32 and counters.shape == (3, 20)
    kept = int(((b["labels"] != 0)
                & (np.arange(CAPS[0]) < b["nnz"])).sum())
    assert int(counters[0].sum()) == int(counters[2].sum()) == kept
    state = TT.TrainState(model, opt, step=1)
    sd = state.state_dict()
    assert sorted(sd) == ["model", "optimizer", "step"]
    other = _port_model(seed=9)
    o_state = TT.TrainState(other, TT.make_sgd(other.parameters(), 0.5))
    o_state.load_state_dict(sd)
    assert o_state.step == 1
    assert o_state.optimizer.param_groups[0]["lr"] == 0.02
    for (k, a), (_, c) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, c), k
    # momentum buffers came across
    bufs = [s["momentum_buffer"] for s in o_state.optimizer.state.values()]
    assert len(bufs) == len(list(other.parameters()))
