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
        [--only A,B,...] [--device cpu]

One line per case: ms per launch (the least over `reps` timings of `iters`
back-to-back launches, CUDA events), Mrows/s, GB/s of gathered or copied
payload (counted once, as the JAX tools count it), the bound (bytes read +
bytes written + the index, at 3.35 TB/s) and the library call's ms. A table
of up to 50 MB stays in the L2 cache, so a rate above the HBM rate is
expected there and is no error. Every result is held exact against the
kernel's plain twin first; a wrong result or a failed launch raises and the
tool exits non-zero. With --device cpu the twins run and the times are host
times, of no use as a measurement.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import kernels

HBM_BYTES_PER_S = 3.35e12
LETTERS = ("A", "B", "C", "D", "O", "A2", "A3", "G", "E2", "P")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def time_ms(fn: Callable[[], object], iters: int, reps: int,
            device: torch.device) -> float:
    """Least time per call over `reps` timings of `iters` back-to-back
    calls: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


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

    def _table(self, n: int, c: int, dtype: str) -> torch.Tensor:
        shape = (n, c) if c else (n,)
        if dtype == "int32":
            a = self.rng.integers(0, 1 << 30, size=shape).astype(np.int32)
            return torch.from_numpy(a).to(self.device)
        a = self.rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(self.device).to(_DTYPES[dtype])

    def _record(self, case: Dict) -> Dict:
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
        hits = int((idx >= 0).sum())
        long_idx = idx.clamp(min=0).long()
        return self._record({
            "kernel": "probe_row_gather", "letter": letter,
            "name": f"{letter} row-gather(N={n},C={c or 1},Q={q},{dtype})"
                    + note,
            "n": n, "row_bytes": row_bytes, "q": q, "hits": hits,
            "rows": q, "payload_bytes": q * row_bytes, "max_abs_err": err,
            "ms": time_ms(lambda: kernels.probe_row_gather(x, idx),
                          self.iters, self.reps, self.device),
            "plain_ms": time_ms(
                lambda: kernels.probe_row_gather_plain(x, idx), self.iters,
                self.reps, self.device),
            "library_ms": time_ms(lambda: x[long_idx], self.iters, self.reps,
                                  self.device),
            # hit rows read, every output row written, the index read
            "bound_ms": ((hits + q) * row_bytes + 4 * q)
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
        del got, want
        row_bytes = c * 4
        copied = s * g * row_bytes
        written = s * (out_rows * row_bytes if out_rows else 4)
        mode = f"BQ={out_rows}" if out_rows else "slab"
        return self._record({
            "kernel": "probe_slab_copy", "letter": letter,
            "name": f"{letter} slab-copy(N={n},C={c},G={g},S={s},{mode},"
                    "float32)",
            "n": n, "row_bytes": row_bytes, "g": g, "s": s,
            "out_rows": out_rows, "rows": s * g, "payload_bytes": copied,
            "max_abs_err": err,
            "ms": time_ms(lambda: kernels.probe_slab_copy(x, offs, g,
                                                          out_rows),
                          self.iters, self.reps, self.device),
            "plain_ms": time_ms(
                lambda: kernels.probe_slab_copy_plain(x, offs, g, out_rows),
                self.iters, self.reps, self.device),
            "library_ms": None,      # no single PyTorch call stages slabs
            "bound_ms": (copied + written + 4 * s) / HBM_BYTES_PER_S * 1e3,
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
            "ms": time_ms(lambda: kernels.probe_empty(x), calls, self.reps,
                          self.device),
            "plain_ms": time_ms(lambda: kernels.probe_empty_plain(x), calls,
                                self.reps, self.device),
            "library_ms": time_ms(lambda: x.clone(), calls, self.reps,
                                  self.device),
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
    Probes(device, args.iters, args.reps).run(only)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
