"""Hand-written Hopper kernels of the sparse path, with their plain twins.

Two kernels, each the port of a Pallas kernel of `link_tpu`:

  * `sorted_join` (csrc/sorted_join.cu) replaces `pallas_join`
    (link_tpu/ops/pallas_kernels.py:62-89): exact lower-bound join of packed
    coordinate keys against a sorted key table.
  * `gather_conv` (csrc/gather_conv.cu) replaces `pallas_sparse_conv`
    (link_tpu/ops/pallas_kernels.py:111-144): out[m] = sum_k
    feats[idx[k, m]] @ W[k], float32 accumulation, idx -1 reads a zero row.

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
SOURCES = ("sorted_join.cu", "gather_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "sorted_join": [_P, _P, _P, _I, _P, _P, _P, _LL, _P],
    "gather_conv": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P],
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
                      q_lo: torch.Tensor) -> torch.Tensor:
    """Plain twin of `sorted_join`: int64 keys, `torch.searchsorted` for the
    lower bound, then the exact-hit test."""
    n = t_hi.shape[0]
    if n == 0:
        return torch.full_like(q_hi, -1)
    tkey = key64(t_hi, t_lo)
    qkey = key64(q_hi, q_lo)
    pos = torch.searchsorted(tkey, qkey).clamp_(max=n - 1)
    hit = (tkey[pos] == qkey) & (q_hi != INT32_MAX)
    return torch.where(hit, perm[pos], torch.full_like(q_hi, -1))


def sorted_join(t_hi: torch.Tensor, t_lo: torch.Tensor, perm: torch.Tensor,
                q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """For each query key pair, perm[lower_bound] on an exact match in the
    (hi, lo)-sorted table, else -1; hi == INT32_MAX always misses.
    Table (N,) int32 x 3, queries (Q,) int32 x 2, result (Q,) int32."""
    if _on_cpu(t_hi, t_lo, perm, q_hi, q_lo):
        return sorted_join_plain(t_hi, t_lo, perm, q_hi, q_lo)
    _check_cuda("sorted_join", t_hi, t_lo, perm, q_hi, q_lo)
    for t in (t_hi, t_lo, perm, q_hi, q_lo):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError("sorted_join: operands must be 1-D int32")
    n, q = t_hi.shape[0], q_hi.shape[0]
    if t_lo.shape[0] != n or perm.shape[0] != n or q_lo.shape[0] != q:
        raise ValueError("sorted_join: mismatched lengths")
    out = torch.empty_like(q_hi)
    if q == 0:
        return out
    rc = _lib("sorted_join").sorted_join(
        t_hi.data_ptr(), t_lo.data_ptr(), perm.data_ptr(), n,
        q_hi.data_ptr(), q_lo.data_ptr(), out.data_ptr(), q, _stream(q_hi))
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


KERNELS = (sorted_join, gather_conv)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
