"""CPU emulations of the probe kernels' work layouts (csrc/probes.cu).

A CUDA kernel cannot run here, so these replay in Python what each thread
of the two redesigned probe kernels computes, with the kernel's constants
read from its source, and hold the result against the plain twins:

  * `probe_slab_copy`: the persistent grid's split of the slabs over the
    blocks, each block's fills (whole slabs packed into a stage, or one
    stage-sized chunk of a larger slab), the ring stage and mbarrier parity
    of every fill, the producer's waits on the "empty" barriers and the
    consumers' on the "full" ones, with TMA copies that land in any order.
    Every byte of every slab that lies in the table is staged exactly once,
    no stage is refilled before all its consumer warps have released it,
    no consumer reads a stage before its copies have landed, and what the
    consumers write equals the twin.
  * `probe_row_gather`: each lane's items, by the carry walk of any width,
    at each number of items a lane a batch the launch can choose (1 or
    GATHER_UNROLL), and the 4-byte kernel's groups of 4
    consecutive queries; every output vector is written exactly once, with
    the twin's value.

The CUDA code itself is held to these layouts on the card, where
`chip_smoke.py` runs `Probes.edges` bit-equal against the twins.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from link_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = (Path(kernels.CSRC) / "probes.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


STAGES = _constant("SLAB_STAGES")
STAGE_BYTES = _constant("SLAB_STAGE_BYTES")
CONSUMERS = _constant("SLAB_CONSUMER_WARPS")
MAX_PER_FILL = _constant("SLAB_MAX_PER_FILL")
UNROLL = _constant("GATHER_UNROLL")
# the items a lane a batch `launch_gather` can choose
PERS = [1, UNROLL]


# --------------------------------------------------------------------------
# probe_slab_copy


def block_slabs(s: int, blocks: int, b: int):
    """Slabs [lo, hi) of block b: S split as evenly as the grid allows."""
    per, rem = s // blocks, s % blocks
    lo = b * per + min(b, rem)
    return lo, lo + per + (1 if b < rem else 0)


def fills(slab: int, lo: int, hi: int):
    """The kernel's `Fills` walk: (first slab, count, byte0, bytes, stage,
    phase) of each fill of one block."""
    whole = slab <= STAGE_BYTES
    per_fill = min(STAGE_BYTES // slab, MAX_PER_FILL) if whole else 1
    first, byte0, stage, phase = lo, 0, 0, 0
    while first < hi:
        if whole:
            count, nbytes = min(hi - first, per_fill), slab
        else:
            count, nbytes = 1, min(STAGE_BYTES, slab - byte0)
        yield first, count, byte0, nbytes, stage, phase
        if whole:
            first += count
        else:
            byte0 += nbytes
            if byte0 == slab:
                byte0, first = 0, first + 1
        stage += 1
        if stage == STAGES:
            stage, phase = 0, phase ^ 1


class Barrier:
    """An mbarrier: `arrivals` expected per phase, a transaction count, and
    the number of completed phases. try_wait.parity(p) holds once the phase
    of parity p has completed, which the hardware reads as: the current
    phase's parity differs from p."""

    def __init__(self, arrivals: int):
        self.arrivals = arrivals
        self.pending = arrivals
        self.tx = 0
        self.completed = 0

    def _maybe_complete(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.arrivals

    def arrive(self, expect_tx: int = 0):
        assert self.pending > 0
        self.tx += expect_tx
        self.pending -= 1
        self._maybe_complete()

    def complete_tx(self, nbytes: int):
        self.tx -= nbytes
        self._maybe_complete()

    def try_wait(self, parity: int) -> bool:
        return (self.completed & 1) != parity


def emulate_block(x_bytes, offs, n, g, row_bytes, out_rows, lo, hi, out,
                  staged, rng):
    """Run one block's producer warp and consumer warps, interleaved at
    random, with each TMA copy landing at a random later step."""
    slab = g * row_bytes
    ob = out_rows * row_bytes
    ring = np.zeros((STAGES, STAGE_BYTES), np.uint8)
    full = [Barrier(1) for _ in range(STAGES)]
    empty = [Barrier(CONSUMERS) for _ in range(STAGES)]
    stage_offs = np.full((STAGES, MAX_PER_FILL), -7, np.int64)
    readers = [0] * STAGES        # consumer warps that took a fill and have
    #                               not released it yet
    in_flight = []                # TMA copies: (stage, dst, src bytes)
    plan = list(fills(slab, lo, hi))
    released = [0] * len(plan)    # consumer warps that released each fill

    def producer():
        for k, (first, count, byte0, nbytes, stage, phase) in enumerate(plan):
            off = [int(offs[first + j]) for j in range(count)]
            off = [o if o >= 0 and o + g <= n else -1 for o in off]
            if k >= STAGES:
                while not empty[stage].try_wait(phase ^ 1):
                    yield
            # the refill: every consumer warp has released the stage's last
            # fill, and none holds it
            assert k < STAGES or released[k - STAGES] == CONSUMERS
            assert readers[stage] == 0, "stage refilled before its release"
            stage_offs[stage, :count] = off
            hits = sum(o >= 0 for o in off)
            full[stage].arrive(hits * nbytes)
            for j, o in enumerate(off):
                if o >= 0:
                    src = o * row_bytes + byte0
                    in_flight.append((stage, j * nbytes,
                                      x_bytes[src:src + nbytes].copy()))
                    staged.append((first + j, byte0, nbytes))
            yield

    def consumer(w):
        for k, (first, count, byte0, nbytes, stage, phase) in enumerate(plan):
            while not full[stage].try_wait(phase):
                yield
            readers[stage] += 1
            # every copy of this fill has landed: none is in flight
            assert not any(c[0] == stage for c in in_flight)
            src = ring[stage]
            so = stage_offs[stage]
            yield
            if out_rows == 0:
                if byte0 == 0 and w == 0:     # consumer thread ct < count
                    for ct in range(count):
                        word = (src[ct * nbytes:ct * nbytes + 4]
                                if so[ct] >= 0 else np.zeros(4, np.uint8))
                        out[4 * (first + ct):4 * (first + ct) + 4] = word
            elif byte0 < ob and w == 0:       # the warps share one loop
                n16 = min(nbytes, ob - byte0) // 16
                for j in range(count):
                    dst = (first + j) * ob + byte0
                    piece = (src[j * nbytes:j * nbytes + 16 * n16]
                             if so[j] >= 0 else np.zeros(16 * n16, np.uint8))
                    out[dst:dst + 16 * n16] = piece
            readers[stage] -= 1
            released[k] += 1
            empty[stage].arrive()
            yield

    actors = [producer()] + [consumer(w) for w in range(CONSUMERS)]
    while actors or in_flight:
        if in_flight and (not actors or rng.random() < 0.3):
            stage, dst, data = in_flight.pop(int(rng.integers(len(in_flight))))
            ring[stage, dst:dst + data.size] = data
            full[stage].complete_tx(data.size)
            continue
        a = actors[int(rng.integers(len(actors)))]
        try:
            next(a)
        except StopIteration:
            actors.remove(a)


def emulate_slab_copy(x: torch.Tensor, offs: np.ndarray, g: int,
                      out_rows: int, blocks: int, seed: int = 0):
    n, c = x.shape
    row_bytes = 4 * c
    s = len(offs)
    x_bytes = x.numpy().view(np.uint8).reshape(-1)
    out = np.zeros(4 * s if out_rows == 0 else s * out_rows * row_bytes,
                   np.uint8)
    staged = []
    rng = np.random.default_rng(seed)
    grid = min(s, blocks)
    for b in range(grid):
        lo, hi = block_slabs(s, grid, b)
        emulate_block(x_bytes, offs, n, g, row_bytes, out_rows, lo, hi, out,
                      staged, rng)
    return out.view(np.float32), staged


def test_kernel_constants():
    # a fill of whole slabs must fit the offsets one producer lane each
    assert MAX_PER_FILL == 32 and STAGES >= 2 and STAGE_BYTES % 16 == 0
    assert UNROLL > 1


@pytest.mark.parametrize("g", [1, 8, 200, 512, 4096])
@pytest.mark.parametrize("row_bytes", [16, 256])
@pytest.mark.parametrize("s,blocks", [(3, 8), (70, 4)])
def test_slab_schedule_stages_every_byte_once(g, row_bytes, s, blocks):
    n = max(2 * g, 600)
    rng = np.random.default_rng(g + row_bytes + s)
    x = torch.from_numpy(rng.standard_normal((n, row_bytes // 4))
                         .astype(np.float32))
    offs = rng.integers(0, n - g + 1, size=s)
    offs[:min(s, 3)] = [-1, n - g + 1, n - g][:min(s, 3)]
    offs = offs.astype(np.int32)
    inside = {i for i, o in enumerate(offs) if 0 <= o and o + g <= n}
    for out_rows in sorted({0, 1, min(g, 8), g}):
        got, staged = emulate_slab_copy(x, offs, g, out_rows, blocks,
                                        seed=out_rows)
        want = kernels.probe_slab_copy_plain(x, torch.from_numpy(offs), g,
                                             out_rows)
        assert np.array_equal(got, want.numpy().reshape(-1)), out_rows
        # every byte of every in-table slab staged exactly once, nothing of
        # a slab outside it
        slab = g * row_bytes
        by_slab = {}
        for sl, byte0, nbytes in staged:
            by_slab.setdefault(sl, []).append((byte0, nbytes))
        assert set(by_slab) == inside
        for pieces in by_slab.values():
            pieces.sort()
            pos = 0
            for byte0, nbytes in pieces:
                assert byte0 == pos and 0 < nbytes <= STAGE_BYTES
                pos += nbytes
            assert pos == slab


def test_slab_fills_walk_each_block():
    # S far above the block count: each block's fills cover its slabs in
    # order, stages in turn, the parity flipping once a round
    s, blocks = 10_000, 132
    for slab in (16, 2048, 32768, 51200, 131072, 1 << 20):
        seen = []
        for b in range(blocks):
            lo, hi = block_slabs(s, blocks, b)
            assert hi - lo in (s // blocks, s // blocks + 1)
            walk = list(fills(slab, lo, hi))
            for k, (first, count, byte0, nbytes, stage, phase) in \
                    enumerate(walk):
                assert stage == k % STAGES and phase == (k // STAGES) % 2
                assert count * nbytes <= STAGE_BYTES and nbytes % 16 == 0
                assert count <= MAX_PER_FILL
                seen.extend(range(first, first + count) if byte0 == 0
                            else [])
        assert seen == list(range(s))


# --------------------------------------------------------------------------
# probe_row_gather


def vector_bytes(row_bytes: int, base: int = 0) -> int:
    """The entry's vector width: the widest of 16, 8, 4, 2 bytes dividing
    the row width and the bases (here `base` stands for both)."""
    mix = row_bytes | base
    return next(w for w in (16, 8, 4, 2) if mix % w == 0)


def emulate_tiles(xv: np.ndarray, idx: np.ndarray, q: int, vpr: int,
                  warps: int, per: int) -> np.ndarray:
    """`row_gather_kernel<V, per>` over `warps` warps: xv (N, vpr) vectors
    (as integers), returns the (Q * vpr,) output vectors, -99 where no lane
    wrote; asserts no vector is written twice."""
    n = xv.shape[0]
    out = np.full(q * vpr, -99, np.int64)
    chunks = -(-vpr // per)
    batches = -(-q // 32) * chunks

    def store(pos, val):
        assert out[pos] == -99, "a vector written twice"
        out[pos] = val

    for b0 in range(warps):
        for b in range(b0, batches, warps):
            tile = b // chunks                # a 32-bit division a batch
            c = b - tile * chunks
            row0 = 32 * tile
            mine = [int(idx[row0 + lane]) if row0 + lane < q else -1
                    for lane in range(32)]
            for lane in range(32):
                r0, v0 = lane // vpr, lane - (lane // vpr) * vpr
                dr, dv = 32 // vpr, 32 - (32 // vpr) * vpr
                cr = (32 * per) // vpr
                cv = 32 * per - cr * vpr
                k0 = c * per
                vec = v0 + c * cv
                row = r0 + c * cr + vec // vpr
                vec -= (vec // vpr) * vpr
                left = q - row0
                for j in range(per):
                    if k0 + j < vpr:
                        src = mine[row]
                        if row < left:
                            store(row0 * vpr + lane + 32 * (k0 + j),
                                  xv[src, vec] if 0 <= src < n else 0)
                    vec += dv
                    row += dr
                    if vec >= vpr:
                        vec -= vpr
                        row += 1
    return out


def emulate_gather4(x: np.ndarray, idx: np.ndarray, q: int,
                    warps: int) -> np.ndarray:
    """`gather4_kernel`: a lane takes 4 consecutive queries, a warp 128."""
    n = x.shape[0]
    out = np.full(q, -99, np.int64)
    batches = -(-q // 128)
    for b0 in range(warps):
        for b in range(b0, batches, warps):
            for lane in range(32):
                r = b * 128 + 4 * lane
                for j in range(4):
                    if r + j < q:
                        i = int(idx[r + j])
                        assert out[r + j] == -99
                        out[r + j] = x[i] if 0 <= i < n else 0
    return out


@pytest.mark.parametrize("row_bytes", [2, 4, 6, 8, 12, 24, 32, 48, 64, 128,
                                       256, 512, 800, 1024])
@pytest.mark.parametrize("per", PERS)
def test_row_gather_items_cover_every_vector(row_bytes, per):
    rng = np.random.default_rng(row_bytes * per)
    n = 300
    width = vector_bytes(row_bytes)
    vpr = row_bytes // width
    x = rng.integers(-(1 << 30), 1 << 30, size=(n, vpr))
    for q, warps in ((1, 1), (33, 2), (1001, 3)):
        idx = rng.integers(-3, n + 3, size=q)
        ok = (idx >= 0) & (idx < n)
        want = np.where(ok[:, None], x[np.where(ok, idx, 0)], 0).reshape(-1)
        got = emulate_tiles(x, idx, q, vpr, warps, per)
        assert np.array_equal(got, want), (q, warps)


@pytest.mark.parametrize("q,warps", [(1, 1), (3, 1), (4, 2), (1001, 3),
                                     (4096, 2)])
def test_gather4_groups_of_four(q, warps):
    rng = np.random.default_rng(q)
    n = 500
    x = rng.integers(-(1 << 30), 1 << 30, size=n)
    idx = rng.integers(-3, n + 3, size=q)
    got = emulate_gather4(x, idx, q, warps)
    ok = (idx >= 0) & (idx < n)
    assert np.array_equal(got, np.where(ok, x[np.where(ok, idx, 0)], 0))


def test_gather_vector_width_and_batch_shape():
    # the rows of the probe cases: (row bytes, vector bytes, vectors a
    # row)
    for row_bytes, width, vpr in ((512, 16, 32), (256, 16, 16),
                                  (128, 16, 8), (64, 16, 4), (32, 16, 2),
                                  (16, 16, 1), (24, 8, 3), (2, 2, 1)):
        assert vector_bytes(row_bytes) == width
        assert row_bytes // width == vpr
    assert vector_bytes(256, base=4) == 4       # a 4-byte-aligned table
