"""Why float32 reaches the tensor cores only as three TF32 passes.

The conv kernels (link_tpu_torch/csrc/gather_conv.cu, gather_wgrad.cu) run
their products on `mma.sync`. A TF32 operand keeps 10 of float32's 23
mantissa bits. These tests emulate the kernels' own split in numpy
(`split_tf32` in csrc/mma_sm90.cuh: the low 13 bits masked off, i.e.
truncation toward zero, for hi and for lo alike) on the stem's submanifold
plan of a real-size synthetic scan (K = 27, 84,992 rows, 64 channels,
weights x 0.125 as `chip_smoke.py` draws them) and hold each form against a
float64 reference with the bound that holds every float32 kernel to its
twin on the card (`chip_smoke.py`, F32_REL_TOL = 1e-5): one TF32 pass
misses it; hi * hi + hi * lo + lo * hi with hi = tf32(x), lo = tf32(x - hi)
meets it with a 10x margin. A static check then holds the sources to the
rule, and to that split.
"""

import os
import re

import numpy as np
import pytest
import torch

from link_tpu_torch.data.collate import collate_scans, to_sparse_tensor
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI, grid_extent
from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.conv import build_conv_plan

F32_REL_TOL = 1e-5     # chip_smoke.py: a float32 kernel against its twin


TF32_MASK = 0xFFFFE000  # split_tf32's mask: sign, exponent, 10 mantissa bits


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 truncated toward zero (the low 13 bits cleared), as
    `split_tf32` does it, as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(TF32_MASK)).view(np.float32)


@pytest.fixture(scope="module")
def seg_case():
    ds = SyntheticSemanticKITTI(length=1, num_points=80000,
                                n_raw_points=120000, split="train")
    ext = grid_extent(0.05, batch_size=1)
    st = to_sparse_tensor(collate_scans([ds[0]], DEFAULT_CAPACITIES[0],
                                        grid_extent=ext),
                          device="cpu", grid_extent=ext)
    idx = build_conv_plan(st.coords, st.coords, st.nnz,
                          C.kernel_offsets_np(3), st.capacity,
                          in_sorted=True).in_idx.numpy()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((st.capacity, 64)).astype(np.float32)
    w = (rng.standard_normal((27, 64, 64)) * 0.125).astype(np.float32)
    return idx, feats, w


def conv(idx, feats, w, product):
    """sum_k feats[idx[k]] @ w[k] over the hits, each tap's product by
    `product(a, b)`."""
    out = None
    for k in range(idx.shape[0]):
        hit = idx[k] >= 0
        part = product(feats[idx[k, hit]], w[k])
        if out is None:
            out = np.zeros((idx.shape[1], w.shape[2]), part.dtype)
        out[hit] += part
    return out


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def three_pass(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_the_plan_is_the_seg_density(seg_case):
    idx, _, _ = seg_case
    assert idx.shape == (27, 84992)
    assert 0.09 < (idx >= 0).mean() < 0.12          # ~10.6% of the slots hit


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1 + 2.0**-10, 1 + 2.0**-11, 1 + 2.0**-12, -3.0000002,
                  1 + 3 * 2.0**-11], np.float32)
    got = tf32(x)
    assert got.tolist() == [1.0, 1 + 2.0**-10, 1.0, 1.0, -3.0,
                            1 + 2.0**-10]
    # the split is exact to 2^-20: hi + lo recovers x but for lo's
    # truncation (as mma_sm90.cuh states)
    y = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    hi = tf32(y)
    lo = tf32(y - hi)
    assert np.all(np.abs(y - hi) < np.abs(y) * 2.0**-10)
    assert np.all(np.abs(y - hi - lo) < np.abs(y) * 2.0**-20)


def test_one_tf32_pass_misses_the_float32_bound(seg_case):
    idx, feats, w = seg_case
    ref = conv(idx, feats.astype(np.float64), w.astype(np.float64),
               lambda a, b: a @ b)
    one = conv(idx, feats, w, lambda a, b: tf32(a) @ tf32(b))
    assert rel_err(one, ref) > F32_REL_TOL


def test_three_tf32_passes_meet_it_with_a_tenfold_margin(seg_case):
    idx, feats, w = seg_case
    ref = conv(idx, feats.astype(np.float64), w.astype(np.float64),
               lambda a, b: a @ b)
    three = conv(idx, feats, w, three_pass)
    plain = conv(idx, feats, w, lambda a, b: a @ b)      # float32 FMAs
    assert rel_err(three, ref) * 10 <= F32_REL_TOL
    assert rel_err(three, ref) < 2 * rel_err(plain, ref) + 1e-7


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_float32_reaches_the_tensor_cores_only_as_three_passes():
    """Every single-pass TF32 MMA sits inside `mma_3xtf32`, and the conv
    kernels call only `mma_3xtf32` (float32) and `mma_bf16` (bfloat16)."""
    header = _strip_comments(open(os.path.join(kernels.CSRC,
                                               "mma_sm90.cuh")).read())
    body = header.split("void mma_3xtf32(")[1].split("\n}\n")[0]
    assert body.count("mma_tf32(") == 3
    assert header.count("mma_tf32(") == 4          # its definition + 3 uses
    for name in ("gather_conv.cu", "gather_wgrad.cu"):
        src = _strip_comments(open(os.path.join(kernels.CSRC, name)).read())
        assert '#include "mma_sm90.cuh"' in src
        assert "mma_tf32(" not in src and "tf32.tf32" not in src, name
        assert "mma_3xtf32(" in src and "mma_bf16(" in src, name
        assert "cvt.rna" not in src, name


def test_the_emulated_split_is_the_kernels():
    """`split_tf32` masks hi and lo with TF32_MASK (truncation), the form
    emulated above, and rounds nothing with `cvt`."""
    header = _strip_comments(open(os.path.join(kernels.CSRC,
                                               "mma_sm90.cuh")).read())
    body = header.split("void split_tf32(")[1].split("\n}\n")[0]
    assert body.count(f"0x{TF32_MASK:x}u") == 2
    assert "cvt" not in body
