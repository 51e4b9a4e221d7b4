"""Port vs JAX: NMS on the device, and the `rotated_nms` kernel's algorithm.

On the same numpy inputs, in the same process:

  * `rotated_iou_bev` against `rotated_iou_bev_jax` (the 24-candidate hull,
    float32 on both sides; the summation order, the trig routines and the
    origin differ: the twin works about each pair's first centre): within
    1e-5 absolute, on contained, identical, touching and zero-area boxes
    among random ones near the origin;
  * `rotated_iou_bev` against the native double-precision clip within 1e-6
    on the closest calls of a det frame's candidates, pairs of neighbouring
    BEV cells 42-54 m from the origin, where `rotated_iou_bev_jax`'s
    absolute coordinates lose more than 5e-5;
  * `rotate_nms_device` against `rotate_nms_jax`, and `device_nms` (one
    `rotated_nms` call over every task and batch row) against JAX's
    `device_nms`: keep masks and gathered rows exactly equal, with tied (bf16-quantized) scores, all-invalid rows,
    N = 1, k < N and a binding max_keep. The inputs are drawn so that no
    valid pair's IoU lies within 1e-5 of the threshold (checked), where the
    two IoU routines could decide a pair differently;
  * the batched twin (S sets in one call) against the per-set calls and
    `rotate_nms_jax`, on S sets of different valid counts (an all-invalid
    one among them) at N = 1, 63, 64, 65 and 1,000;
  * a CPU emulation of the kernel's algorithm (csrc/rotated_nms.cu: ranks
    counted on a canonical total-order key, the rank-ordered upper-triangle
    mask with the earlier rank as the clip's subject, the walk 64 ranks at
    a time on each chunk's diagonal word, capped) with the native clip's
    IoU, against `rotate_nms_jax`, exactly, signed zeros, NaN and -inf
    scores included, one set and S sets;
  * both circle NMS versions against JAX's, exactly;
  * `SingleFramePredictor(device_nms=True)` against the JAX predictor with
    `device_nms=True` on the tiny frame with shared weights (labels exact,
    boxes and scores to 1e-4), and against the port's host-NMS predictor.
On the CPU the `rotated_nms` wrapper runs its twin; the kernel itself runs
on the card only, held against the twin by chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.inference import SingleFramePredictor as JPredictor
from link_tpu.models.center_head import device_nms as j_device_nms
from link_tpu.ops import nms as jnms
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch import native
from link_tpu_torch.inference import SingleFramePredictor as TPredictor
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models import center_head as t_center_head
from link_tpu_torch.models.center_head import device_nms as t_device_nms
from link_tpu_torch.ops import kernels
from link_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEAR = 1e-5          # a pair this close to the threshold may flip
TINY = dict(max_voxels=4000, capacity=4096, grid_shape=(48, 48, 40),
            test_cfg=dict(pc_range=[-12, -12], voxel_size=[0.5, 0.5],
                          post_center_limit_range=[-15, -15, -10, 15, 15,
                                                   10]))


def _boxes5(n, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 3.0, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def _special_boxes():
    """Contained, identical, touching (a shared edge, a shared corner) and
    zero-area boxes. A box with w = l = 0 is left out: every point passes
    the hull's inside test of such a box, and `rotated_iou_bev_jax` gives it
    IoUs far above 1 with boxes metres away; a decoded box has w, l =
    exp(dim) > 0."""
    return np.array([
        [0, 0, 4, 2, 0.3], [0, 0, 1, 0.5, 0.3],        # contained
        [5, 5, 2, 3, 1.0], [5, 5, 2, 3, 1.0],          # identical
        [-6, 0, 2, 2, 0], [-4, 0, 2, 2, 0],            # a shared edge
        [-6, -6, 2, 2, 0], [-4, -4, 2, 2, 0],          # a shared corner
        [0, 5, 0, 2, 0.7], [0, 5, 2, 2, 0.2],          # zero width
        [3, -5, 0, 1, 0], [3, -5, 1, 1, 0]], np.float32)  # inside, zero area


_jax_iou_jit = jax.jit(jnms.rotated_iou_bev_jax)
_jax_nms_jit = jax.jit(jnms.rotate_nms_jax, static_argnums=(3, 4))


@functools.lru_cache(maxsize=None)
def _jax_iou_of(key):
    return np.asarray(_jax_iou_jit(jnp.asarray(np.frombuffer(
        key, np.float32).reshape(-1, 5))))


def _jax_iou(boxes):
    return _jax_iou_of(np.ascontiguousarray(boxes, np.float32).tobytes())


def _jax_nms(boxes, scores, valid, thresh, max_keep):
    return np.asarray(_jax_nms_jit(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), thresh, max_keep))


def _near_pairs(iou, valid, thresh):
    both = valid[:, None] & valid[None, :] & ~np.eye(len(valid), dtype=bool)
    return int((both & (np.abs(iou - thresh) < NEAR)).sum())


def test_rotated_iou_matches_jax():
    boxes = np.concatenate([_special_boxes(), _boxes5(52, 1)])
    want = _jax_iou(boxes)
    got = tnms.rotated_iou_bev(torch.from_numpy(boxes)).numpy()
    assert got.shape == want.shape == (64, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(got[0, 1] - 0.0625) < 1e-5 and abs(got[2, 3] - 1) < 1e-5
    assert got[4, 5] < 1e-5 and got[6, 7] < 1e-5
    assert got[8, 9] == 0 and got[10, 11] == 0


# the pair of each of a det frame's six tasks (bf16 CenterPoint-ELKv3 at the
# 160k cap, seed-0 weights, SyntheticNuScenes val frame 0) whose IoU the
# kernel's float64 clip and JAX's float32 hull put furthest apart: boxes
# (x y w l r) of neighbouring BEV cells at the edge of the nuScenes range,
# IoUs 0.19-0.26 against the threshold 0.2
FAR_PAIRS = np.array([
    [42.024757385253906, -52.177879333496094, 0.9965574145317078,
     1.0317434072494507, 0.3413558602333069],
    [42.62476348876953, -52.177879333496094, 0.9965574145317078,
     1.0317434072494507, 0.3413558602333069],
    [49.23194122314453, -53.97480392456055, 1.0140751600265503,
     0.9802992343902588, -2.291152238845825],
    [49.831939697265625, -53.97480392456055, 1.0140751600265503,
     0.9802992343902588, -2.291152238845825],
    [-44.391578674316406, -52.221534729003906, 0.9859997630119324,
     0.9549058079719543, 0.9211224913597107],
    [-44.9915771484375, -52.221534729003906, 0.9859997630119324,
     0.9549058079719543, 0.9211224913597107],
    [-53.9909553527832, 45.59855651855469, 1.0267179012298584,
     0.9701801538467407, -1.4608519077301025],
    [-53.9909553527832, 46.19855499267578, 1.0267179012298584,
     0.9701801538467407, -1.4608519077301025],
    [-46.177001953125, -53.39692306518555, 1.0459461212158203,
     1.003791332244873, -2.9734582901000977],
    [-46.17744064331055, -53.99553298950195, 1.0278464555740356,
     0.9985972046852112, 3.0890769958496094],
    [53.410552978515625, -53.40069580078125, 1.022465467453003,
     0.9820957779884338, 1.5678083896636963],
    [53.40776824951172, -53.99468994140625, 1.0248396396636963,
     0.980418860912323, 1.4803321361541748]], np.float32)


@pytest.mark.parametrize("pair", range(6))
def test_rotated_iou_far_from_origin(pair):
    """The twin's IoU is within 1e-6 of the native double-precision clip
    (the kernel's algorithm) 42-54 m from the origin, where the float32
    shoelace of `rotated_iou_bev_jax` over absolute coordinates is more than
    5e-5 off (1e-4 to 2.7e-4, by how XLA orders the sums); the pair moved
    to the origin agrees with all three."""
    b = FAR_PAIRS[2 * pair:2 * pair + 2]
    b7 = np.zeros((2, 7), np.float32)
    b7[:, [0, 1, 3, 4, 6]] = b
    b7[:, 5] = 1
    want = float(native.bev_iou(b7, b7)[0, 1])
    assert 0.18 < want < 0.26
    got = float(tnms.rotated_iou_bev(torch.from_numpy(b))[0, 1])
    assert abs(got - want) < 1e-6
    assert abs(float(_jax_iou(b)[0, 1]) - want) > 5e-5
    moved = b.copy()
    moved[:, :2] -= b[0, :2]
    assert abs(float(_jax_iou(moved)[0, 1]) - want) < 1e-6



def _case(name):
    """(boxes, scores, valid, max_keep) of one NMS case."""
    rng = np.random.default_rng(7)
    if name == "random":
        n = 120
        scores = rng.random(n).astype(np.float32)
        return _boxes5(n, 2), scores, rng.random(n) > 0.15, 120
    if name == "tied":                        # bf16-quantized logits
        n = 100
        logits = torch.tensor(rng.integers(-12, 12, n) / 6.0,
                              dtype=torch.bfloat16).float().numpy()
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
        return _boxes5(n, 3, spread=4.0), scores, rng.random(n) > 0.1, 12
    if name == "all_invalid":
        n = 30
        return (_boxes5(n, 4), rng.random(n).astype(np.float32),
                np.zeros(n, bool), 10)
    if name == "single":
        return _boxes5(1, 5), np.ones(1, np.float32), np.ones(1, bool), 83
    if name == "special":
        boxes = _special_boxes()
        scores = np.linspace(1, 0.5, len(boxes)).astype(np.float32)
        return boxes, scores, np.ones(len(boxes), bool), 83
    raise KeyError(name)


CASES = ("random", "tied", "all_invalid", "single", "special")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("thresh", [0.01, 0.2, 0.5])
def test_rotate_nms_device_matches_jax(name, thresh):
    boxes, scores, valid, max_keep = _case(name)
    assert _near_pairs(_jax_iou(boxes), valid, thresh) == 0
    want = _jax_nms(boxes, scores, valid, thresh, max_keep)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), thresh, max_keep)
    got = tnms.rotate_nms_device(*args).numpy()
    np.testing.assert_array_equal(got, want)
    # on the CPU the kernel's wrapper takes the twin
    np.testing.assert_array_equal(kernels.rotated_nms(*args).numpy(), want)
    assert got.sum() <= max_keep and not (got & ~valid).any()
    if name == "tied":
        assert len(np.unique(scores)) < len(scores) // 3
        assert got.sum() == max_keep            # the cap binds


def test_rotated_nms_wrapper_raises_off_the_cpu():
    b = torch.zeros((4, 5), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.rotated_nms(b, torch.zeros(4, device="meta"),
                            torch.ones(4, dtype=torch.bool, device="meta"),
                            0.2, 4)


def _sort_key(scores):
    """csrc/rotated_nms.cu sort_key: -score as a total-order int32, -0 as
    +0 and every NaN as +NaN."""
    f = -scores.astype(np.float32)
    f = np.where(f == 0, np.float32(0), f)
    bits = f.view(np.int32).copy()
    bits[np.isnan(f)] = 0x7fc00000
    return bits ^ ((bits >> 31) & 0x7fffffff)


INT32_MAX = 2**31 - 1


def _word(bits):
    """A row of at most 64 bools as one uint64 word, bit k = bits[k]."""
    padded = np.zeros(64, bool)
    padded[:len(bits)] = bits
    return np.packbits(padded, bitorder="little").view("<u8")[0]


def _kernel_algorithm(boxes, scores, valid, thresh, max_keep, tile=64,
                      warps=8):
    """The three launches of csrc/rotated_nms.cu, on the CPU, for one set
    or, with a leading dimension, for S sets (each on its own, as the
    kernel's blocks of one set see nothing of another's):
      1. ranks: each valid row counts the valid rows before it on a
         canonical total-order key (invalid rows keyed INT32_MAX), each of
         `warps` warps an equal span of the columns, the spans' counts
         summed; the rows placed at their ranks (`order`);
      2. the pair mask in rank order, upper triangle only: per (row tile
         <= column tile) of the valid ranks, bit (r, c) for c > r when the
         native clip's IoU with rank r, the earlier, as the subject exceeds
         thresh;
      3. the walk, 64 ranks at a time: each chunk resolved serially on its
         diagonal word (keep a rank no kept rank removed, OR in its bits),
         stopping at max_keep keeps; then the kept rows' words of the
         later chunks ORed into `removed`. The keep is written in input
         order through `order`."""
    if scores.ndim == 2:
        return np.stack([_kernel_algorithm(b, sc, v, thresh, max_keep, tile,
                                           warps)
                         for b, sc, v in zip(boxes, scores, valid)])
    n = len(scores)
    # launch 1
    key = np.where(valid, _sort_key(scores), np.int32(INT32_MAX))
    idx = np.arange(n)
    span = -(-n // warps)
    rank = np.zeros(n, np.int64)
    for w in range(warps):
        j = idx[w * span:(w + 1) * span]
        rank += ((key[j][None, :] < key[:, None])
                 | ((key[j][None, :] == key[:, None])
                    & (j[None, :] < idx[:, None]))).sum(1)
    nv = int(valid.sum())
    order = np.full(nv, -1, np.int64)
    order[rank[valid]] = idx[valid]
    assert (np.sort(rank[valid]) == np.arange(nv)).all()
    # launch 2
    b7 = np.zeros((nv, 7), np.float32)
    b7[:, [0, 1, 3, 4, 6]] = boxes[order]
    b7[:, 5] = 1
    over = native.bev_iou(b7, b7) > thresh
    words = -(-nv // tile)
    mask = np.zeros((nv, words), np.uint64)
    for rt in range(words):
        for ct in range(rt, words):
            for r in range(rt * tile, min(nv, (rt + 1) * tile)):
                c = np.arange(ct * tile, min(nv, (ct + 1) * tile))
                mask[r, ct] = _word(over[r, c] & (c > r))
    # launch 3
    removed = np.zeros(words, np.uint64)
    keep = np.zeros(n, bool)
    kept = 0
    for c in range(words):
        if kept >= max_keep:
            break
        rem, kb = int(removed[c]), 0
        for b in range(min(tile, nv - c * tile)):
            if kept >= max_keep:
                break
            if not (rem >> b) & 1:
                kb |= 1 << b
                kept += 1
                rem |= int(mask[c * tile + b, c])
        for b in range(tile):
            if (kb >> b) & 1:
                keep[order[c * tile + b]] = True
                removed[c + 1:] |= mask[c * tile + b, c + 1:]
    return keep


@pytest.mark.parametrize("name", CASES + ("odd_scores",))
def test_kernel_algorithm_matches_jax(name):
    if name == "odd_scores":       # signed zeros, NaN, -inf, +inf, ties
        boxes, _, valid, max_keep = _case("random")
        rng = np.random.default_rng(11)
        scores = rng.choice(np.array([0.0, -0.0, np.nan, -np.inf, np.inf,
                                      0.5, 0.25], np.float32), len(valid))
    else:
        boxes, scores, valid, max_keep = _case(name)
    for thresh in (0.01, 0.2, 0.5):
        assert _near_pairs(_jax_iou(boxes), valid, thresh) == 0
        want = _jax_nms(boxes, scores, valid, thresh, max_keep)
        np.testing.assert_array_equal(
            _kernel_algorithm(boxes, scores, valid, thresh, max_keep), want)
        np.testing.assert_array_equal(tnms.rotate_nms_device(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), thresh, max_keep).numpy(), want)


def _task_outs(seed, b=2, n=96, ncls=(1, 2, 2)):
    """Decoded-shaped candidates: per task boxes (B, N, 9), scores from
    bf16-quantized logits (many ties), int32 labels and a mask; batch row 1
    of the last task has no valid row."""
    rng = np.random.default_rng(seed)
    outs, off = [], 0
    for t, c in enumerate(ncls):
        boxes = np.zeros((b, n, 9), np.float32)
        boxes[..., :2] = rng.uniform(-5, 5, (b, n, 2))
        boxes[..., 2] = rng.uniform(-1, 1, (b, n))
        boxes[..., 3:6] = rng.uniform(0.5, 3, (b, n, 3))
        boxes[..., 6:8] = rng.normal(0, 1, (b, n, 2))
        boxes[..., 8] = rng.uniform(-np.pi, np.pi, (b, n))
        logits = torch.tensor(rng.integers(-10, 10, (b, n)) / 4.0,
                              dtype=torch.bfloat16).float().numpy()
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
        labels = (rng.integers(0, c, (b, n)) + off).astype(np.int32)
        mask = (scores > 0.3) & (rng.random((b, n)) > 0.1)
        if t == len(ncls) - 1:
            mask[1] = False
        outs.append((boxes, scores, labels, mask))
        off += c
    return outs


def test_device_nms_matches_jax(monkeypatch):
    """Both packages' `device_nms` on the same decoded outputs, with the
    config's pre-NMS cap; the port stacks every task and batch row into
    one `rotated_nms` call."""
    cfg = dict(nms_pre_max_size=64, nms_post_max_size=10,
               nms_iou_threshold=0.2)
    outs = _task_outs(0)
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return kernels.rotated_nms(*args)

    monkeypatch.setattr(t_center_head, "rotated_nms", counting)
    want = j_device_nms([tuple(jnp.asarray(a) for a in t) for t in outs],
                        cfg)
    got = t_device_nms([tuple(torch.from_numpy(a) for a in t)
                        for t in outs], cfg)
    assert calls == [(3 * 2, 64, 5)]
    for (gb, gs, gl, gk), (wb, ws, wl, wk) in zip(got, want):
        assert gb.shape == (2, 64, 9) and gk.dtype == torch.bool
        for g, w in ((gb, wb), (gs, ws), (gl, wl), (gk, wk)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        bev = np.asarray(wb)[..., [0, 1, 3, 4, 8]]
        valid = np.asarray(ws) > 0
        for i in range(2):
            assert _near_pairs(_jax_iou(bev[i]), valid[i], 0.2) == 0
    keeps = np.stack([k.numpy() for *_, k in got])
    assert keeps[:, 0].sum(-1).max() == 10 and keeps[-1, 1].sum() == 0


def _batched_sets(n):
    """S candidate sets of N = n with different valid counts: a dense set
    with float scores, a sparse one with tied (bf16-quantized) scores, one
    with signed zeros, NaN and infinite scores, and an all-invalid set."""
    rng = np.random.default_rng(100 + n)
    spread = 0.8 * np.sqrt(n) + 1
    boxes = np.stack([_boxes5(n, 200 + n + s, spread) for s in range(4)])
    logits = torch.tensor(rng.integers(-8, 8, n) / 4.0,
                          dtype=torch.bfloat16).float().numpy()
    scores = np.stack([
        rng.random(n).astype(np.float32),
        (1 / (1 + np.exp(-logits))).astype(np.float32),
        rng.choice(np.array([0.0, -0.0, np.nan, -np.inf, np.inf, 0.5, 0.25],
                            np.float32), n),
        rng.random(n).astype(np.float32)])
    valid = np.stack([rng.random(n) > 0.1, rng.random(n) > 0.6,
                      rng.random(n) > 0.3, np.zeros(n, bool)])
    return boxes, scores, valid


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_batched_nms_matches_sets_and_jax(n):
    """One call over S sets (the batched twin, and the kernel's wrapper,
    which takes it on the CPU) gives each set what its own call gives and
    what `rotate_nms_jax` gives; the CPU emulation of the kernel's three
    launches too. N = 1,000 runs the det config's threshold and cap only
    (its IoUs are seconds each on the CPU)."""
    boxes, scores, valid = _batched_sets(n)
    cases = ((0.2, 83),) if n == 1000 else ((0.01, n), (0.2, 83), (0.5, 5))
    for thresh, max_keep in cases:
        for s in range(len(boxes)):
            assert _near_pairs(_jax_iou(boxes[s]), valid[s], thresh) == 0
        args = (torch.from_numpy(boxes), torch.from_numpy(scores),
                torch.from_numpy(valid), thresh, max_keep)
        got = tnms.rotate_nms_device(*args).numpy()
        assert got.shape == (4, n) and got.dtype == bool
        if n < 1000:
            np.testing.assert_array_equal(kernels.rotated_nms(*args).numpy(),
                                          got)
        np.testing.assert_array_equal(
            _kernel_algorithm(boxes, scores, valid, thresh, max_keep), got)
        for s in range(len(boxes)):
            one = tnms.rotate_nms_device(
                torch.from_numpy(boxes[s]), torch.from_numpy(scores[s]),
                torch.from_numpy(valid[s]), thresh, max_keep).numpy()
            np.testing.assert_array_equal(got[s], one)
            np.testing.assert_array_equal(
                got[s], _jax_nms(boxes[s], scores[s], valid[s], thresh,
                                 max_keep))
        assert not got[3].any() and not (got & ~valid).any()
        assert (got.sum(1) <= max_keep).all()
        if n > 1:
            assert got[0].sum() > 1


def test_circle_nms_matches_jax():
    rng = np.random.default_rng(5)
    n = 80
    xy = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    scores = np.round(rng.random(n) * 10).astype(np.float32) / 10
    valid = rng.random(n) > 0.2
    for radius, post in ((0.5, 83), (2.0, 5)):
        want = np.asarray(jnms.circle_nms_jax(
            jnp.asarray(xy), jnp.asarray(scores), jnp.asarray(valid), radius,
            post))
        got = tnms.circle_nms_device(torch.from_numpy(xy),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(valid), radius, post)
        np.testing.assert_array_equal(got.numpy(), want)
        order = np.argsort(-scores, kind="stable")
        host = np.concatenate([xy, scores[:, None]], 1)[order]
        np.testing.assert_array_equal(tnms.circle_nms(host, radius, post),
                                      jnms.circle_nms(host, radius, post))
        assert 1 < want.sum() <= post


def test_predictor_with_device_nms_matches_jax():
    sd = TPredictor(seed=1, device="cpu", **TINY).model.state_dict()
    for k in sd:
        if k.endswith("hm.3.bias"):
            sd[k] = torch.zeros_like(sd[k])
    tp = TPredictor(state_dict=sd, device="cpu", device_nms=True, **TINY)
    jp = JPredictor(device_nms=True, **TINY)
    # the JAX predictor's model at the port's level capacities
    jp.model = jp.model.clone(capacities=det_capacities(TINY["capacity"], 1))
    tr = translate_voxelnet({k: v.detach().clone().numpy()
                             for k, v in sd.items()})
    jp._vars = True                      # skip its own init: shared weights
    jp._params, jp._bstats = tr["params"], tr["batch_stats"]
    rng = np.random.default_rng(2)       # test_torch_det_serving.py's frame
    pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4.9, 2.9, 3000)
    pts[:, 3] = rng.uniform(0, 255, 3000)
    outs = tp.forward(tp.voxelize(pts))
    for boxes, scores, _, keep in outs:        # no pair near the threshold
        bev = boxes[0][:, [0, 1, 3, 4, 8]].numpy()
        assert _near_pairs(_jax_iou(bev), scores[0].numpy() > 0, 0.2) == 0
    got = tp.postprocess(outs)
    want = jp.predict(pts)
    host = TPredictor(state_dict=sd, device="cpu", **TINY).predict(pts)
    assert len(got["scores"]) > 5
    for other, tol in ((want, 1e-4), (host, 0)):
        np.testing.assert_array_equal(got["label_preds"],
                                      other["label_preds"])
        for k in ("scores", "box3d_lidar"):
            np.testing.assert_allclose(got[k], other[k], rtol=tol, atol=tol)
