"""The counted work: valid kernel-map pairs against hand counts on tiny
grids, and a count that depends on the inputs and the configuration only."""

import json
from pathlib import Path

import torch

from perfbench.count import peaks, work
from perfbench.scenes import audit

BENCH = Path(__file__).resolve().parents[1]


def _rows(*xyz, b=0):
    return torch.tensor([[x, y, z, b] for x, y, z in xyz])


def test_submanifold_pairs_by_hand():
    # a line of three voxels: each sees itself, the middle one both ends
    line = _rows((0, 0, 0), (1, 0, 0), (2, 0, 0))
    assert work.subm_pairs(line, 3, 1) == 3 + 2 + 2
    # an L of three voxels: every pair lies within one step (the 3^3
    # window holds the diagonal), so each sees all three
    ell = _rows((0, 0, 0), (1, 0, 0), (1, 1, 0))
    assert work.subm_pairs(ell, 3, 1) == 3 + 2 * 3
    # two voxels two steps apart at stride 1 never meet; at stride 2 they do
    far = _rows((0, 0, 0), (2, 0, 0))
    assert work.subm_pairs(far, 3, 1) == 2
    assert work.subm_pairs(far, 3, 2) == 4
    # batches never meet
    two = torch.cat([_rows((0, 0, 0)), _rows((1, 0, 0), b=1)])
    assert work.subm_pairs(two, 3, 1) == 2


def test_strided_spconv_output_set_by_hand():
    # k3 s2 p1 on a 1-D row of cells: input x reaches outputs j with
    # 2j - 1 <= x <= 2j + 1
    one = _rows((2, 2, 2))
    out, shape = audit.spconv_out(one, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                  (8, 8, 8))
    assert shape == (4, 4, 4)
    assert out.shape[0] == 1                    # even x: one output an axis
    odd = _rows((3, 3, 3))
    out, _ = audit.spconv_out(odd, (3, 3, 3), (2, 2, 2), (1, 1, 1), (8, 8, 8))
    assert out.shape[0] == 8                    # odd x: two an axis


def test_linkunet_count_depends_on_the_inputs_only():
    cfg = json.loads((BENCH / "configs/linkunet_semkitti.json").read_text())
    g = torch.Generator().manual_seed(0)
    coords = torch.cat([torch.randint(0, 40, (3000, 3), generator=g),
                        torch.zeros(3000, 1, dtype=torch.long)], 1)
    coords = torch.unique(coords, dim=0)
    perm = torch.randperm(coords.shape[0], generator=g)
    a = work.totals(work.linkunet_train_calls(coords, cfg), 495e12, 3.35e12)
    b = work.totals(work.linkunet_train_calls(coords[perm], cfg), 495e12,
                    3.35e12)
    assert a == b
    # the forward's stem products by hand: 2 x pairs x 4 x 64
    calls = work.linkunet_train_calls(coords, cfg)
    stem = [c for c in calls if c.name == "stem.0"]
    pairs = work.subm_pairs(coords, 3, 1)
    assert {c.role for c in stem} == {"fwd", "wgrad"}     # input needs none
    assert stem[0].flops == 2.0 * pairs * 4 * 64
    # every forward call has its weight gradient, all but the stem and the
    # positional linears their feature gradient
    fwd = [c for c in calls if c.role == "fwd"]
    assert len([c for c in calls if c.role == "wgrad"]) == len(fwd)
    assert len([c for c in calls if c.role == "dgrad"]) == len(fwd) - 5


def test_peaks_are_the_data_sheet_rates():
    assert peaks.peak_flops("bfloat16") == 989e12
    assert peaks.peak_flops("float32") == 495e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
