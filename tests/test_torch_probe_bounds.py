"""The probe tool's bounds and its interleaved readings, on the CPU twins.

A probe's bound counts each byte it must move once: every distinct table
row read (a row gathered twice, or covered by two overlapping slabs, is
read once), every output byte written, the index. The readings of row 4c
and of the empty launch alternate kernel and library call (kernel, library,
library, kernel, ...) and report each side's median and spread. Everything
here is exact integer arithmetic, or host times that are only checked to be
positive.
"""

import numpy as np
import pytest
import torch

from link_tpu_torch.tools import probe_gather as pg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("offs,g,n,want", [
    ([0, 4, 8], 4, 100, 12),            # disjoint, touching
    ([0, 2, 3], 4, 100, 7),             # overlapping: rows 0..6
    ([10, 0, 10], 4, 100, 8),           # a repeated slab counts once
    ([0, 97, -1], 4, 100, 4),           # slabs that leave the table read none
    ([], 4, 100, 0),
    ([5, 1, 3, 30, 31], 8, 100, 21),    # rows 1..12 and 30..38
])
def test_distinct_slab_rows(offs, g, n, want):
    assert pg.distinct_slab_rows(np.array(offs, np.int64), g, n) == want


def test_distinct_slab_rows_matches_a_set():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n, g = 500, int(rng.integers(1, 40))
        offs = rng.integers(-5, n, size=int(rng.integers(1, 60)))
        rows = {r for o in offs if 0 <= o and o + g <= n
                for r in range(o, o + g)}
        assert pg.distinct_slab_rows(offs, g, n) == len(rows)


def test_interleaved_order_medians_and_spreads():
    calls = []
    first = iter([5.0, 1.0, 3.0, 2.0, 4.0])
    second = iter([10.0, 10.0, 12.0, 11.0, 10.0])

    def a():
        calls.append("a")
        return next(first)

    def b():
        calls.append("b")
        return next(second)

    r = pg.interleaved(a, b, 5)
    assert "".join(calls) == "abbaabbaab"
    assert r["first"]["readings"] == [5.0, 1.0, 3.0, 2.0, 4.0]
    assert r["first"]["median"] == 3.0 and r["first"]["spread"] == 4.0
    assert r["second"]["median"] == 10.0 and r["second"]["spread"] == 2.0


def test_row_gather_bound_counts_each_table_row_once():
    p = pg.Probes("cpu", iters=1, reps=1, log=lambda s: None)
    idx = torch.tensor([3, 3, 3, -1, 7, 7, 0], dtype=torch.int32)
    case = p.row_gather("A", 16, 4, 0, "float32", idx=idx)
    # distinct rows 0, 3, 7 of 16 B; 7 rows written; 4 B of index each
    assert case["distinct_rows"] == 3 and case["hits"] == 6
    assert case["bound_ms"] == pytest.approx(
        ((3 + 7) * 16 + 4 * 7) / pg.HBM_BYTES_PER_S * 1e3)


def test_readings_run_on_the_twins():
    lines = []
    p = pg.Probes("cpu", iters=1, reps=1, log=lines.append)
    got = p.readings(2)
    assert [r["kernel"] for r in got] == ["probe_row_gather"] * 3 + [
        "probe_empty"]
    assert len(lines) == 4
    for r in got:
        for side in ("kernel_ms", "library_ms"):
            assert len(r[side]["readings"]) == 2
            assert r[side]["median"] > 0 and r[side]["spread"] >= 0
        assert r["margin_ms"] == pytest.approx(
            r["kernel_ms"]["median"] - r["library_ms"]["median"])
        assert isinstance(r["loses_beyond_spread"], bool)


def test_edges_run_on_the_twins():
    # the kernels' edge cases (chip_smoke.py holds them on the card): both
    # kernels, each case bit-equal (here twin against twin), the slab sizes
    # above one block's shared memory and of a stage and a part among them
    p = pg.Probes("cpu", iters=1, reps=1, log=lambda s: None)
    got = p.edges()
    assert all(r["bit_equal"] for r in got)
    names = [r["name"] for r in got]
    assert sum(r["kernel"] == "probe_slab_copy" for r in got) == 14
    assert "N=8192 C=64 G=2048 S=6 out_rows=2048" in names
    assert "N=8192 C=64 G=200 S=300 out_rows=200" in names
    assert "C=6 float32 N=3000 Q=1" in names
    assert "C=1 int32, 4-byte-aligned index N=3000 Q=1001" in names
