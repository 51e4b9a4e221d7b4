"""Gather-rate, slab-copy and launch-overhead probes on the card.

Counterpart of tools/probe_mosaic.py and tools/probe_mosaic2.py: the same
probe letters at the same shapes, through the hand-written probe kernels of
`link_tpu_torch/csrc/probes.cu` instead of Pallas calls:

  A   row gather out[q] = x[idx[q]] (the jnp.take probe)
  B   1-D gather of int32 elements
  C   the one-hot MXU gather's shapes, as a row gather (the output contract
      is ported, not the one-hot)
  D   slab copies into shared memory at dynamic row offsets (the DMA probe)
  E   the library gather x[idx] at A's shapes (printed beside every row
      gather as `lib`)
  O   one empty launch: host time per call through the wrapper, device-side
      launch interval, and the loop floor with no kernel at all
  A2  the take_along_axis probe's shapes, as a row gather
  A3  lane gather out[r, j] = x[r, idx[r, j]] as one-element rows
  G   dynamic window fetch: a BW-row window per output block of BQ rows
  E2  27 x 86,016 rows of 64 float32
  P   the port's own shapes: tables of 84,992 and 169,984 rows of 64
      float32, 64 bfloat16, 16 and 32 float32; Q = N random rows and Q =
      27 N with the hit pattern of a real submanifold plan (misses are -1)

    python3 -m link_tpu_torch.tools.probe_gather [--iters N] [--reps N]
        [--only A,B,...] [--device cpu] [--readings N] [--edges]

--readings N then takes N interleaved readings (kernel, library, library,
kernel, ...) of C's three shapes against `x[idx]` and of O against `clone`,
and prints each side's median and spread and whether the kernel loses by
more than the larger spread. --edges then holds the edge cases of
`Probes.edges` bit-equal against the twins.

One line per case: ms per launch (the least over `reps` replays of a CUDA
graph of `iters` back-to-back launches, so that it reads the card's time
and not the host's launch interval, `link_tpu_torch.utils.timing`; a failed
capture is logged and CUDA events around the launches taken instead),
Mrows/s, GB/s of gathered or copied
payload (counted once, as the JAX tools count it), the bound (each distinct
table row read once + bytes written + the index, at 3.35 TB/s) and the
library call's ms. A table
of up to 50 MB stays in the L2 cache, so a rate above the HBM rate is
expected there and is no error. Every result is held exact against the
kernel's plain twin first; a wrong result or a failed launch raises and the
tool exits non-zero. With --device cpu the twins run and the times are host
times, of no use as a measurement.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import kernels
from ..utils.timing import device_ms

HBM_BYTES_PER_S = 3.35e12
LETTERS = ("A", "B", "C", "D", "O", "A2", "A3", "G", "E2", "P")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def time_ms(fn: Callable[[], object], iters: int, reps: int,
            device: torch.device, modes: Optional[List[str]] = None) -> float:
    """Least time per call over `reps` timings of `iters` back-to-back
    calls: on the card `device_ms` (a CUDA graph's replay, or CUDA events
    where the capture fails), on the CPU the host clock. How the card's time was taken
    is appended to `modes`."""
    if device.type == "cuda":
        ms, mode = device_ms(fn, iters, reps)
        if modes is not None:
            modes.append(mode)
        return ms
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def distinct_slab_rows(offs: np.ndarray, g: int, n: int) -> int:
    """Table rows covered by the slabs [off, off + g) that lie inside the
    table (a slab that leaves it reads nothing), each row counted once."""
    offs = np.sort(offs[(offs >= 0) & (offs + g <= n)].astype(np.int64))
    if offs.size == 0:
        return 0
    ends = offs + g
    # a slab adds the rows past the furthest end of the slabs before it
    reach = np.maximum.accumulate(ends)
    prev = np.concatenate([[offs[0]], reach[:-1]])
    return int((ends - np.maximum(offs, prev)).clip(min=0).sum())


def interleaved(first: Callable[[], float], second: Callable[[], float],
                n: int) -> Dict:
    """`n` readings of each of two timings taken in the order first,
    second, second, first, first, second, ...: the readings, their medians
    and spreads (largest - smallest)."""
    got = {"first": [], "second": []}
    for i in range(2 * n):
        who = "first" if i % 4 in (0, 3) else "second"
        got[who].append((first if who == "first" else second)())
    out = {}
    for who, vals in got.items():
        out[who] = {"readings": vals, "median": float(np.median(vals)),
                    "spread": float(max(vals) - min(vals))}
    return out


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| (integers widened so the difference cannot
    wrap)."""
    if not got.is_floating_point():
        got, want = got.long(), want.long()
    return float((got - want).abs().max())


class Probes:
    """Runs probe cases on one device and collects one dict per case."""

    def __init__(self, device="cuda", iters: int = 8, reps: int = 3,
                 log: Callable[[str], None] = print, seed: int = 0):
        self.device = torch.device(device)
        self.iters = iters
        self.reps = reps
        self.log = log
        self.rng = np.random.default_rng(seed)
        self.results: List[Dict] = []
        self._modes: List[str] = []    # timing modes of the case at hand

    def _table(self, n: int, c: int, dtype: str) -> torch.Tensor:
        shape = (n, c) if c else (n,)
        if dtype == "int32":
            a = self.rng.integers(0, 1 << 30, size=shape).astype(np.int32)
            return torch.from_numpy(a).to(self.device)
        a = self.rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(self.device).to(_DTYPES[dtype])

    def _time(self, fn, iters: Optional[int] = None) -> float:
        return time_ms(fn, iters or self.iters, self.reps, self.device,
                       self._modes)

    def _record(self, case: Dict) -> Dict:
        if self._modes:
            case["timing"] = self._modes
            for mode in set(self._modes):
                if "failed" in mode:
                    self.log(f"{case['name']}: {mode}")
        self._modes = []
        lib = case.get("library_ms")
        self.log(f"{case['name']:60s} {case['ms']:9.4f} ms "
                 f"{case['rows'] / case['ms'] / 1e3:10.1f} Mrows/s "
                 f"{case['payload_bytes'] / case['ms'] / 1e6:8.1f} GB/s  "
                 f"bound {case['bound_ms']:.4f} ms  lib "
                 + (f"{lib:.4f} ms" if lib is not None else "-"))
        self.results.append(case)
        return case

    def row_gather(self, letter: str, n: int, c: int, q: int, dtype: str,
                   idx: Optional[torch.Tensor] = None,
                   note: str = "") -> Dict:
        """One row-gather case: exact against the twin, then timed beside
        the library gather. c == 0 is a 1-D table. `idx` (Q,) int32 with -1
        for a miss replaces the uniform random rows."""
        x = self._table(n, c, dtype)
        if idx is None:
            idx = torch.from_numpy(self.rng.integers(0, n, size=(q,)).astype(
                np.int32)).to(self.device)
        q = idx.shape[0]
        got = kernels.probe_row_gather(x, idx)
        want = kernels.probe_row_gather_plain(x, idx)
        if not torch.equal(got, want):
            raise AssertionError(f"probe_row_gather {letter} N={n} C={c} "
                                 f"Q={q} {dtype}: differs from the twin")
        err = max_abs_err(got, want)
        del got, want
        row_bytes = x.element_size() * max(c, 1)
        valid = (idx >= 0) & (idx < n)
        hits = int(valid.sum())
        distinct = int(torch.unique(idx[valid]).numel())
        long_idx = idx.clamp(min=0).long()
        return self._record({
            "kernel": "probe_row_gather", "letter": letter,
            "name": f"{letter} row-gather(N={n},C={c or 1},Q={q},{dtype})"
                    + note,
            "n": n, "row_bytes": row_bytes, "q": q, "hits": hits,
            "distinct_rows": distinct,
            "rows": q, "payload_bytes": q * row_bytes, "max_abs_err": err,
            "ms": self._time(lambda: kernels.probe_row_gather(x, idx)),
            "plain_ms": self._time(
                lambda: kernels.probe_row_gather_plain(x, idx)),
            "library_ms": self._time(lambda: x[long_idx]),
            # each distinct table row read once, every output row written,
            # the index read
            "bound_ms": ((distinct + q) * row_bytes + 4 * q)
                        / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
        })

    def slab_copy(self, letter: str, n: int, c: int, g: int, s: int,
                  out_rows: int = 0, block_offsets: bool = False) -> Dict:
        """One slab-copy case on a float32 table: S slabs of G rows, slab
        mode (out_rows 0) or window mode. `block_offsets` draws offsets on
        multiples of G, as the scalar-prefetch probe does."""
        x = self._table(n, c, "float32")
        if block_offsets:
            offs = self.rng.integers(0, n // g, size=(s,)) * g
        else:
            offs = self.rng.integers(0, n - g, size=(s,))
        offs = torch.from_numpy(offs.astype(np.int32)).to(self.device)
        got = kernels.probe_slab_copy(x, offs, g, out_rows)
        want = kernels.probe_slab_copy_plain(x, offs, g, out_rows)
        if not torch.equal(got, want):
            raise AssertionError(f"probe_slab_copy {letter} G={g} S={s} "
                                 f"out_rows={out_rows}: differs from the "
                                 "twin")
        err = max_abs_err(got, want)
        # the library yardstick: one indexing call that gives the same
        # output (it reads only those rows; the probe stages whole slabs).
        # Slab mode: each slab's first element; window mode, on offsets
        # that are multiples of G: the first out_rows rows of a G-row block
        if out_rows == 0:
            offs_l = offs.long()
            library = lambda: x[offs_l, 0]                     # noqa: E731
        elif block_offsets and n % g == 0:
            blocks, wb = x.unflatten(0, (n // g, g)), (offs // g).long()
            library = lambda: blocks[wb, :out_rows]            # noqa: E731
        else:
            library = None
        if library is not None and not torch.equal(
                library().reshape(want.shape), want):
            raise AssertionError(f"probe_slab_copy {letter} G={g} S={s}: "
                                 "the library call's output differs")
        del got, want
        row_bytes = c * 4
        copied = s * g * row_bytes
        distinct = distinct_slab_rows(offs.cpu().numpy(), g, n)
        written = s * (out_rows * row_bytes if out_rows else 4)
        mode = f"BQ={out_rows}" if out_rows else "slab"
        return self._record({
            "kernel": "probe_slab_copy", "letter": letter,
            "name": f"{letter} slab-copy(N={n},C={c},G={g},S={s},{mode},"
                    "float32)",
            "n": n, "row_bytes": row_bytes, "g": g, "s": s,
            "out_rows": out_rows, "rows": s * g, "payload_bytes": copied,
            "distinct_rows": distinct, "max_abs_err": err,
            "ms": self._time(lambda: kernels.probe_slab_copy(x, offs, g,
                                                             out_rows)),
            "plain_ms": self._time(
                lambda: kernels.probe_slab_copy_plain(x, offs, g, out_rows)),
            "library_ms": None if library is None else self._time(library),
            # each distinct table row the slabs cover read once (overlapping
            # slabs share rows), the output written, the offsets read
            "bound_ms": (distinct * row_bytes + written + 4 * s)
                        / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
        })

    def empty(self, calls: int = 2000) -> Dict:
        """The empty launch, timed two ways, beside a loop with no kernel."""
        x = torch.zeros((8, 128), dtype=torch.float32, device=self.device)
        got, want = kernels.probe_empty(x), kernels.probe_empty_plain(x)
        if not torch.equal(got, want):
            raise AssertionError("probe_empty: differs from the twin")

        def host_us(fn) -> float:
            best = float("inf")
            for _ in range(self.reps):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                best = min(best, (time.perf_counter() - t0) * 1e6 / calls)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return best

        case = {
            "kernel": "probe_empty", "letter": "O",
            "name": "O empty launch (8,128) float32", "rows": 8,
            "payload_bytes": 4096, "max_abs_err": max_abs_err(got, want),
            "ms": self._time(lambda: kernels.probe_empty(x), calls),
            "plain_ms": self._time(lambda: kernels.probe_empty_plain(x),
                                   calls),
            "library_ms": self._time(lambda: x.clone(), calls),
            "bound_ms": 2 * 4096 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "host_us_per_call": host_us(lambda: kernels.probe_empty(x)),
            "host_us_no_kernel": host_us(lambda: torch.empty_like(x)),
        }
        self._record(case)
        self.log(f"{'O host time per call through the wrapper':60s} "
                 f"{case['host_us_per_call']:9.2f} us")
        self.log(f"{'O no kernel at all (loop floor: the output alloc)':60s} "
                 f"{case['host_us_no_kernel']:9.2f} us")
        return case

    def readings(self, n: int = 6) -> List[Dict]:
        """Interleaved readings (kernel, library, library, kernel, ...; `n`
        of each, each the mean over one replay of `iters` launches) of row
        4c's shapes (the one-hot probe's, C, against `x[idx]`) and of the
        empty launch (O, against `clone`): medians and spreads, and whether
        the kernel loses by more than the larger spread."""
        cases = [("C", 2048, 128, 2048), ("C", 8192, 128, 2048),
                 ("C", 2048, 64, 4096)]
        out = []
        for letter, n_rows, c, q in cases:
            x = self._table(n_rows, c, "bfloat16")
            idx = torch.from_numpy(self.rng.integers(
                0, n_rows, size=(q,)).astype(np.int32)).to(self.device)
            if not torch.equal(kernels.probe_row_gather(x, idx),
                               kernels.probe_row_gather_plain(x, idx)):
                raise AssertionError(f"probe_row_gather {letter} N={n_rows} "
                                     "differs from the twin")
            long_idx = idx.long()
            out.append(self._decide(
                f"{letter} row-gather(N={n_rows},C={c},Q={q},bfloat16) vs "
                "x[idx]", "probe_row_gather",
                lambda: kernels.probe_row_gather(x, idx),
                lambda: x[long_idx], n))
        z = torch.zeros((8, 128), dtype=torch.float32, device=self.device)
        out.append(self._decide("O empty launch vs clone", "probe_empty",
                                lambda: kernels.probe_empty(z),
                                lambda: z.clone(), n))
        return out

    def _decide(self, name, kernel, run_kernel, run_library, n) -> Dict:
        r = interleaved(lambda: time_ms(run_kernel, self.iters, 1,
                                        self.device, self._modes),
                        lambda: time_ms(run_library, self.iters, 1,
                                        self.device, self._modes), n)
        k, lib = r["first"], r["second"]
        margin = k["median"] - lib["median"]
        case = {"kernel": kernel, "name": name, "kernel_ms": k,
                "library_ms": lib, "margin_ms": margin,
                "loses_beyond_spread": margin > max(k["spread"],
                                                    lib["spread"]),
                "timing": sorted(set(self._modes))}
        self._modes = []
        self.log(f"{name:60s} kernel median {k['median']:.5f} ms (spread "
                 f"{k['spread']:.5f}), library median {lib['median']:.5f} ms "
                 f"(spread {lib['spread']:.5f}): the kernel "
                 + ("loses beyond the spread" if case["loses_beyond_spread"]
                    else "does not lose beyond the spread"))
        return case

    def edges(self) -> List[Dict]:
        """The edges of the probe kernels' work layouts, each held bit-equal
        against its twin (a mismatch or a failed launch raises); not timed.
        `probe_slab_copy`: a slab above the 232,448 B one block's shared
        memory holds (G=2048 at 256 B, cut into stage-sized chunks), a slab
        of no whole number of stages (G=200 at 256 B), out_rows = G, 20,000
        slabs (far more than the grid's blocks) and 3 (fewer), 16-byte rows
        one to a slab, a slab larger than the table, and offsets -1, 0,
        N - G and N - G + 1 in each. `probe_row_gather`: rows of 24 and 12 B (3
        vectors a row), 2 and 6 B, 8, 32 and 64 B (1, 2 and 4 vectors),
        128 B, 800 and 1,024 B (rows wider than a warp), a 4-byte-aligned
        table of 256 B rows (4-byte vectors), 4-byte rows with an index
        16-byte aligned and not, Q = 1001, 1, 3 and 0, and indices -1 and
        >= N; then rows of 5 and 6 vectors at Q = 2 and 1.5 million, which
        on the H100 take the kernel of 4 items a lane (32 waves of the
        card's lanes or more), a lane's items crossing rows."""
        out = []

        def check(kernel, name, got, want):
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{kernel} edge {name}: differs from "
                                     "the twin")
            out.append({"kernel": kernel, "name": name, "bit_equal": True})

        for n, c, g, s, rows in ((8192, 64, 2048, 6, (0, 8, 2048)),
                                 (8192, 64, 200, 300, (0, 130, 200)),
                                 (86016, 64, 8, 20000, (0, 8)),
                                 (8192, 64, 64, 3, (0, 64)),
                                 (5000, 4, 1, 5000, (0, 1)),
                                 (100, 4, 128, 4, (0, 64))):
            x = self._table(n, c, "float32")
            offs = self.rng.integers(0, max(n - g, 1), size=(s,))
            edge = np.array([-1, 0, n - g, n - g + 1])
            offs[:min(s, 4)] = edge[:min(s, 4)]
            offs = torch.from_numpy(offs.astype(np.int32)).to(self.device)
            for r in rows:
                check("probe_slab_copy",
                      f"N={n} C={c} G={g} S={s} out_rows={r}",
                      kernels.probe_slab_copy(x, offs, g, r),
                      kernels.probe_slab_copy_plain(x, offs, g, r))

        def gather(name, x, q, idx=None):
            n = x.shape[0]
            if idx is None:
                idx = torch.from_numpy(self.rng.integers(
                    -3, n + 3, size=(q,)).astype(np.int32)).to(self.device)
            check("probe_row_gather", f"{name} N={n} Q={idx.shape[0]}",
                  kernels.probe_row_gather(x, idx),
                  kernels.probe_row_gather_plain(x, idx))

        for c, dtype in ((6, "float32"), (3, "int32"), (0, "bfloat16"),
                         (3, "bfloat16"), (2, "float32"), (8, "float32"),
                         (16, "float32"), (32, "float32"), (200, "float32"),
                         (256, "float32"), (0, "int32"), (64, "float32")):
            x = self._table(3000, c, dtype)
            for q in (1001, 1, 3, 0):
                gather(f"C={c or 1} {dtype}", x, q)
        flat = self._table(3000 * 64 + 1, 0, "float32")
        gather("C=64 float32, 4-byte-aligned table",
               flat[1:].view(3000, 64), 1001)
        x = self._table(3000, 0, "int32")
        idx = torch.from_numpy(self.rng.integers(-3, 3003, size=(1002,))
                               .astype(np.int32)).to(self.device)
        gather("C=1 int32, 4-byte-aligned index", x, 0, idx[1:])
        for c, q in ((10, 2_000_000), (24, 1_500_000)):
            gather(f"C={c} float32", self._table(3000, c, "float32"), q)
        return out

    def plan_index(self, n_scans: int) -> torch.Tensor:
        """(27, N) kernel map of the stem's submanifold plan over a
        synthetic batch of `n_scans` 80k-voxel scans (N = n_scans * 84,992
        rows)."""
        from ..data.collate import collate_scans, to_sparse_tensor
        from ..data.semantic_kitti import SyntheticSemanticKITTI
        from ..models.linkunet import DEFAULT_CAPACITIES
        from ..sparse import coords as C
        from ..sparse.conv import build_conv_plan
        ds = SyntheticSemanticKITTI(length=n_scans, num_points=80000,
                                    n_raw_points=120000, split="train")
        batch = collate_scans([ds[i] for i in range(n_scans)],
                              n_scans * DEFAULT_CAPACITIES[0])
        st = to_sparse_tensor(batch, device=self.device)
        return build_conv_plan(st.coords, st.coords, st.nnz,
                               C.kernel_offsets_np(3), st.capacity,
                               in_sorted=True).in_idx

    def run(self, only=None) -> List[Dict]:
        want = (lambda k: True) if only is None else (lambda k: k in only)
        if want("A"):
            self.row_gather("A", 4096, 128, 4096, "float32")
            for n in (8192, 32768, 86016):
                for dtype in ("float32", "bfloat16"):
                    self.row_gather("A", n, 128, 32768, dtype)
            self.row_gather("A", 32768, 256, 32768, "bfloat16")
            self.row_gather("A", 86016, 64, 86016, "float32")
            self.row_gather("A", 86016, 64, 86016, "bfloat16")
            self.row_gather("A", 86016, 128, 32768, "float32")
        if want("B"):
            self.row_gather("B", 86016, 0, 86016, "int32")
        if want("C"):
            for l in (2048, 8192):
                self.row_gather("C", l, 128, 2048, "bfloat16")
            self.row_gather("C", 2048, 64, 4096, "bfloat16")
        if want("D"):
            for g in (8, 64, 512):
                self.slab_copy("D", 86016, 64, g, 512)
        if want("O"):
            self.empty()
        if want("A2"):
            self.row_gather("A2", 4096, 128, 4096, "float32")
            self.row_gather("A2", 32768, 128, 32768, "float32")
            self.row_gather("A2", 32768, 128, 262144, "float32")
            self.row_gather("A2", 86016, 128, 262144, "bfloat16")
            self.row_gather("A2", 86016, 64, 262144, "float32")
            self.row_gather("A2", 86016, 8, 262144, "float32")
            self.row_gather("A2", 8, 128, 8, "float32")
            self.row_gather("A2", 16, 128, 2048, "float32")
        if want("A3"):
            # out[r, j] = x[r, idx[r, j]] over the flat index r * n + idx
            r, n = 8, 2048
            lane = self.rng.integers(0, n, size=(r, n))
            flat = (np.arange(r)[:, None] * n + lane).reshape(-1)
            self.row_gather(
                "A3", r * n, 0, r * n, "float32",
                idx=torch.from_numpy(flat.astype(np.int32)).to(self.device),
                note=" lane gather (8,2048)")
        if want("G"):
            for bw in (8, 32, 128, 512):
                self.slab_copy("G", 86016, 64, bw, 86016 // 8, out_rows=8,
                               block_offsets=True)
            self.slab_copy("G", 86016, 64, 512, 86016 // 512, out_rows=512,
                           block_offsets=True)
        if want("E2"):
            self.row_gather("E2", 86016, 64, 27 * 86016, "float32")
        if want("P"):
            for n_scans in (1, 2):
                in_idx = self.plan_index(n_scans)
                n = in_idx.shape[1]
                hit = float((in_idx >= 0).float().mean())
                flat = in_idx.reshape(-1)
                for c, dtype in ((64, "float32"), (64, "bfloat16"),
                                 (16, "float32"), (32, "float32")):
                    self.row_gather("P", n, c, n, dtype)
                    self.row_gather("P", n, c, 27 * n, dtype, idx=flat,
                                    note=f" plan, {hit:.1%} hit")
        return self.results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma-separated probe letters of " + ",".join(LETTERS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--readings", type=int, default=0,
                    help="then N interleaved readings of 4c and O against "
                         "their library calls")
    ap.add_argument("--edges", action="store_true",
                    help="then the edge cases, bit-equal against the twins")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(LETTERS):
        ap.error(f"unknown probe letters {sorted(only - set(LETTERS))}")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run the "
                               "plain twins")
        print("torch", torch.__version__, "device",
              torch.cuda.get_device_name(device))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0])
    probes = Probes(device, args.iters, args.reps)
    probes.run(only)
    if args.readings:
        probes.readings(args.readings)
    if args.edges:
        print(f"# edges: {len(probes.edges())} cases bit-equal to the twins")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
