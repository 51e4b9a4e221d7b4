"""Hand-written Hopper kernels of the sparse path, with their plain twins.

Three kernels, each the port of a Pallas kernel of `link_tpu`:

  * `sorted_join` (csrc/sorted_join.cu) replaces `pallas_join`
    (link_tpu/ops/pallas_kernels.py:62-89): lower-bound join of packed
    coordinate keys against a sorted key table, in two modes: the exact
    hit (perm[pos] or -1) and the lower bound itself (the window plan's
    base rows).
  * `gather_conv` (csrc/gather_conv.cu) replaces `pallas_sparse_conv`
    (link_tpu/ops/pallas_kernels.py:111-144): out[m] = sum_k
    feats[idx[k, m]] @ W[k], float32 accumulation, idx -1 reads a zero row.
  * `window_conv` (csrc/window_conv.cu) replaces `onehot_window_conv`
    (link_tpu/ops/pallas_kernels.py:179-276): the same sum with input rows
    addressed as base_pos[g, m] + slot[t, m] for tap t of group g.

Each wrapper takes its plain PyTorch twin (same contract, same module) when
its tensors lie on the CPU, and launches its kernel when they lie on a CUDA
device; any other device raises. There is no fallback from the kernel to the
twin. Each wrapper counts its kernel launches in `<wrapper>.launches`.

The kernels are compiled at first use with `nvcc` for sm_90a into
`link_tpu_torch/_build/` (one shared library with a plain C interface per
source, built in parallel, named by a hash of source and flags) and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

INT32_MAX = 2**31 - 1

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sorted_join.cu", "gather_conv.cu", "window_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "sorted_join": [_P, _P, _P, _I, _P, _P, _P, _LL, _I, _P],
    "gather_conv": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P],
    "window_conv": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I,
                    _P],
}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _so_path(src: str) -> Path:
    text = (CSRC / src).read_bytes() + " ".join(NVCC_FLAGS).encode()
    tag = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}-{tag}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source that has no up-to-date library, one nvcc
    process per source, all started together. Returns {source: compiler
    output} for the sources built by this call (ptxas register and shared
    memory report)."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in SOURCES:
            so = _so_path(src)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, so)
        logs = {}
        failed = []
        for src, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            logs[src] = out
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_kernels()
        lib = ctypes.CDLL(str(_so_path(f"{name}.cu")))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}; the kernel takes "
                             "CUDA tensors (CPU tensors take the plain twin)")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# --------------------------------------------------------------------------
# sorted_join


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key per (hi, lo) pair. Both halves are non-negative int32,
    so the int64 order equals the lexicographic (hi, lo) order."""
    return hi.to(torch.int64) * (2**31) + lo.to(torch.int64)


def sorted_join_plain(t_hi: torch.Tensor, t_lo: torch.Tensor,
                      perm: torch.Tensor, q_hi: torch.Tensor,
                      q_lo: torch.Tensor,
                      mode: str = "exact") -> torch.Tensor:
    """Plain twin of `sorted_join`: int64 keys, `torch.searchsorted` for the
    lower bound, then the exact-hit test (mode "exact") or the bound clamped
    to n - 1 (mode "lower_bound")."""
    _check_mode(mode)
    n = t_hi.shape[0]
    if n == 0:
        return torch.full_like(q_hi, -1)
    tkey = key64(t_hi, t_lo)
    qkey = key64(q_hi, q_lo)
    pos = torch.searchsorted(tkey, qkey).clamp_(max=n - 1)
    if mode == "lower_bound":
        return pos.to(torch.int32)
    hit = (tkey[pos] == qkey) & (q_hi != INT32_MAX)
    return torch.where(hit, perm[pos], torch.full_like(q_hi, -1))


_JOIN_MODES = {"exact": 0, "lower_bound": 1}


def _check_mode(mode: str) -> None:
    if mode not in _JOIN_MODES:
        raise ValueError(f"sorted_join: mode {mode!r} (exact, lower_bound)")


def sorted_join(t_hi: torch.Tensor, t_lo: torch.Tensor, perm: torch.Tensor,
                q_hi: torch.Tensor, q_lo: torch.Tensor,
                mode: str = "exact") -> torch.Tensor:
    """Lower bound of each query key pair in the (hi, lo)-sorted table.
    mode "exact": perm[lower_bound] on an exact match, else -1; hi ==
    INT32_MAX always misses. mode "lower_bound": the bound itself, clamped
    to n - 1, for every query (perm is not read). Table (N,) int32 x 3,
    queries (Q,) int32 x 2, result (Q,) int32."""
    _check_mode(mode)
    if _on_cpu(t_hi, t_lo, perm, q_hi, q_lo):
        return sorted_join_plain(t_hi, t_lo, perm, q_hi, q_lo, mode)
    _check_cuda("sorted_join", t_hi, t_lo, perm, q_hi, q_lo)
    for t in (t_hi, t_lo, perm, q_hi, q_lo):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError("sorted_join: operands must be 1-D int32")
    n, q = t_hi.shape[0], q_hi.shape[0]
    if t_lo.shape[0] != n or perm.shape[0] != n or q_lo.shape[0] != q:
        raise ValueError("sorted_join: mismatched lengths")
    if n == 0:
        return torch.full_like(q_hi, -1)
    out = torch.empty_like(q_hi)
    if q == 0:
        return out
    rc = _lib("sorted_join").sorted_join(
        t_hi.data_ptr(), t_lo.data_ptr(), perm.data_ptr(), n,
        q_hi.data_ptr(), q_lo.data_ptr(), out.data_ptr(), q,
        _JOIN_MODES[mode], _stream(q_hi))
    _raise_on("sorted_join", rc)
    sorted_join.launches += 1
    return out


sorted_join.launches = 0


# --------------------------------------------------------------------------
# gather_conv

_CONV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Plain twin of `gather_conv`: per-tap index and matmul, products and
    sum in float32 (exact products for bfloat16 inputs), one rounding to the
    feature dtype at the end."""
    n, ci = feats.shape
    k, m = idx.shape
    co = weight.shape[2]
    w = weight.to(feats.dtype).to(torch.float32)
    ext = torch.cat([feats, feats.new_zeros((1, ci))]).to(torch.float32)
    safe = torch.where(idx >= 0, idx, torch.full_like(idx, n)).long()
    acc = torch.zeros((m, co), dtype=torch.float32, device=feats.device)
    for kk in range(k):
        acc += ext[safe[kk]] @ w[kk]
    return acc.to(feats.dtype)


def gather_conv(feats: torch.Tensor, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """out[m] = sum_k feats[idx[k, m]] @ weight[k]; idx < 0 reads a zero row.
    feats (N, Ci) float32 or bfloat16, idx (K, M) int32, weight (K, Ci, Co)
    (cast to the feature dtype). Returns (M, Co) in the feature dtype."""
    if _on_cpu(feats, idx, weight):
        return gather_conv_plain(feats, idx, weight)
    weight = weight.to(feats.dtype).contiguous()
    _check_cuda("gather_conv", feats, idx, weight)
    if feats.dtype not in _CONV_DTYPES:
        raise ValueError(f"gather_conv: feature dtype {feats.dtype} "
                         "(float32 and bfloat16 are supported)")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("gather_conv: idx must be (K, M) int32")
    n, ci = feats.shape
    k, m = idx.shape
    if weight.dim() != 3 or weight.shape[:2] != (k, ci):
        raise ValueError(f"gather_conv: weight {tuple(weight.shape)} does not "
                         f"match K={k}, Ci={ci}")
    co = weight.shape[2]
    out = torch.empty((m, co), dtype=feats.dtype, device=feats.device)
    if m == 0 or co == 0:
        return out
    rc = _lib("gather_conv").gather_conv(
        feats.data_ptr(), n, ci, idx.data_ptr(), k, m, weight.data_ptr(), co,
        out.data_ptr(), _CONV_DTYPES[feats.dtype], _stream(feats))
    _raise_on("gather_conv", rc)
    gather_conv.launches += 1
    return out


gather_conv.launches = 0


# --------------------------------------------------------------------------
# window_conv

WINDOW_MAX_TAPS = 8     # taps per group and window width the kernel takes
_group_tables: Dict[tuple, tuple] = {}


def _group_arrays(groups, device) -> tuple:
    """(taps, goff) int32 on `device`: tap ids group by group, and group g's
    entries at taps[goff[g]:goff[g + 1]]. Cached per (groups, device)."""
    key = (groups, str(device))
    arrs = _group_tables.get(key)
    if arrs is None:
        flat = [t for taps in groups for t in taps]
        off = [0]
        for taps in groups:
            off.append(off[-1] + len(taps))
        arrs = (torch.tensor(flat, dtype=torch.int32, device=device),
                torch.tensor(off, dtype=torch.int32, device=device))
        _group_tables[key] = arrs
    return arrs


def window_conv_plain(feats: torch.Tensor, base_pos: torch.Tensor,
                      slot: torch.Tensor, groups,
                      weight: torch.Tensor) -> torch.Tensor:
    """Plain twin of `window_conv`: for each tap, the row base_pos[g] +
    slot[t] (a slot < 0 or >= the window width, or a row past the table,
    reads zero), one matmul per tap, products and sum in float32, one
    rounding to the feature dtype at the end."""
    n, ci = feats.shape
    m = slot.shape[1]
    co = weight.shape[2]
    gw = max(len(t) for t in groups)
    w = weight.to(feats.dtype).to(torch.float32)
    ext = torch.cat([feats, feats.new_zeros((1, ci))]).to(torch.float32)
    acc = torch.zeros((m, co), dtype=torch.float32, device=feats.device)
    for g, taps in enumerate(groups):
        base = base_pos[g].long()
        for t in taps:
            s = slot[t].long()
            row = base + s
            ok = (s >= 0) & (s < gw) & (row >= 0) & (row < n)
            acc += ext[torch.where(ok, row, torch.full_like(row, n))] @ w[t]
    return acc.to(feats.dtype)


def window_conv(feats: torch.Tensor, base_pos: torch.Tensor,
                slot: torch.Tensor, groups,
                weight: torch.Tensor) -> torch.Tensor:
    """out[m] = sum_g sum_{t in groups[g]} feats[base_pos[g, m] + slot[t, m]]
    @ weight[t], where slot < 0 (a miss) reads a zero row. feats (N, Ci)
    float32 or bfloat16, base_pos (Gg, M) int32, slot (K, M) int8, groups a
    tuple of tap-id tuples (Gg of them), weight (K, Ci, Co) (cast to the
    feature dtype). Returns (M, Co) in the feature dtype."""
    if _on_cpu(feats, base_pos, slot, weight):
        return window_conv_plain(feats, base_pos, slot, groups, weight)
    weight = weight.to(feats.dtype).contiguous()
    _check_cuda("window_conv", feats, base_pos, slot, weight)
    if feats.dtype not in _CONV_DTYPES:
        raise ValueError(f"window_conv: feature dtype {feats.dtype} "
                         "(float32 and bfloat16 are supported)")
    if base_pos.dtype != torch.int32 or base_pos.dim() != 2:
        raise ValueError("window_conv: base_pos must be (Gg, M) int32")
    if slot.dtype != torch.int8 or slot.dim() != 2:
        raise ValueError("window_conv: slot must be (K, M) int8")
    n, ci = feats.shape
    k, m = slot.shape
    if base_pos.shape != (len(groups), m):
        raise ValueError(f"window_conv: base_pos {tuple(base_pos.shape)} for "
                         f"{len(groups)} groups and M={m}")
    if sorted(t for taps in groups for t in taps) != list(range(k)):
        raise ValueError("window_conv: groups must hold each tap once")
    gw = max(len(t) for t in groups)
    if gw > WINDOW_MAX_TAPS:
        raise ValueError(f"window_conv: a group of {gw} taps (at most "
                         f"{WINDOW_MAX_TAPS})")
    if weight.dim() != 3 or weight.shape[:2] != (k, ci):
        raise ValueError(f"window_conv: weight {tuple(weight.shape)} does not "
                         f"match K={k}, Ci={ci}")
    co = weight.shape[2]
    out = torch.empty((m, co), dtype=feats.dtype, device=feats.device)
    if m == 0 or co == 0:
        return out
    if n == 0:
        return out.zero_()
    taps, goff = _group_arrays(groups, feats.device)
    rc = _lib("window_conv").window_conv(
        feats.data_ptr(), n, ci, base_pos.data_ptr(), slot.data_ptr(), m,
        taps.data_ptr(), goff.data_ptr(), len(groups), gw, weight.data_ptr(),
        co, out.data_ptr(), _CONV_DTYPES[feats.dtype], _stream(feats))
    _raise_on("window_conv", rc)
    window_conv.launches += 1
    return out


window_conv.launches = 0


KERNELS = (sorted_join, gather_conv, window_conv)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
