"""Hand-written Hopper kernels of the sparse path, with their plain twins.

Seven kernels. Three are ports of the Pallas kernels of
`link_tpu/ops/pallas_kernels.py`:

  * `sorted_join` (csrc/sorted_join.cu) replaces `pallas_join` (:62-89):
    lower-bound join of packed coordinate keys against a sorted key table,
    in two modes: the exact hit (perm[pos] or -1) and the lower bound
    itself (the window plan's base rows).
  * `gather_conv` (csrc/gather_conv.cu) replaces `pallas_sparse_conv`
    (:111-144): out[m] = sum_k feats[idx[k, m]] @ W[k], float32
    accumulation, idx -1 reads a zero row. In training it also computes the
    feature gradient, over the inverse kernel map with W[k]^T.
  * `window_conv` (csrc/window_conv.cu) replaces `onehot_window_conv`
    (:179-276): the same sum with input rows addressed as base_pos[g, m] +
    slot[t, m] for tap t of group g.

One has no Pallas counterpart:

  * `gather_wgrad` (csrc/gather_wgrad.cu) replaces the XLA product of
    `_gm_bwd_core` (link_tpu/sparse/conv.py:608-622): the weight gradient
    dW[k] = sum_i feats[i]^T (x) g[bwd_idx[k, i]], without the gathered
    copy of g.

Three replace the Mosaic probes of tools/probe_mosaic.py and
tools/probe_mosaic2.py (csrc/probes.cu): `probe_row_gather`,
`probe_slab_copy` and `probe_empty`.

Each wrapper takes its plain PyTorch twin (same contract, same module) when
its tensors lie on the CPU, and launches its kernel when they lie on a CUDA
device; any other device raises. There is no fallback from the kernel to the
twin. Each wrapper counts its kernel launches in `<wrapper>.launches`, and
carries its source file and what it replaces (`.source`, `.replaces`);
`KERNELS` lists the wrappers.

The kernels are compiled at first use with `nvcc` for sm_90a into
`link_tpu_torch/_build/` (one shared library with a plain C interface per
source, built in parallel, named by a hash of the source, the shared headers
of csrc/ and the flags) and loaded with ctypes.

The conv kernels run their products on the tensor cores (csrc/mma_sm90.cuh):
bfloat16 through the bf16 MMA, float32 only as three TF32 passes (hi * hi +
hi * lo + lo * hi), never as one: a single TF32 pass misses the 1e-5 bound
that holds every float32 kernel to its twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

INT32_MAX = 2**31 - 1

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sorted_join.cu", "gather_conv.cu", "window_conv.cu",
           "gather_wgrad.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
KERNELS = []        # the wrappers, in the order they are defined


def _kernel(fn, source: str, replaces: str, argtypes) -> None:
    """Register a wrapper: its launch count, the CUDA source that holds its
    entry point (of the wrapper's name), what it replaces, and the entry
    point's C argument types."""
    if source not in SOURCES:
        raise ValueError(f"{source} is not in SOURCES")
    fn.launches = 0
    fn.source = source
    fn.replaces = replaces
    fn.argtypes = argtypes
    KERNELS.append(fn)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _so_path(src: str, csrc: Path = CSRC) -> Path:
    """The library of one source, named by a hash of the source, every
    header of `csrc` (a quoted #include finds them beside the source) and
    the flags, so that editing any of them builds anew."""
    h = hashlib.sha1((csrc / src).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


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


def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of one source, with the argument types of every
    registered entry point in it."""
    lib = _libs.get(source)
    if lib is None:
        build_kernels()
        lib = ctypes.CDLL(str(_so_path(source)))
        for wrapper in KERNELS:
            if wrapper.source == source:
                fn = getattr(lib, wrapper.__name__)
                fn.argtypes = wrapper.argtypes
                fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def _entry(wrapper):
    """The C entry point behind a registered wrapper."""
    return getattr(_lib(wrapper.source), wrapper.__name__)


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
    rc = _entry(sorted_join)(
        t_hi.data_ptr(), t_lo.data_ptr(), perm.data_ptr(), n,
        q_hi.data_ptr(), q_lo.data_ptr(), out.data_ptr(), q,
        _JOIN_MODES[mode], _stream(q_hi))
    _raise_on("sorted_join", rc)
    sorted_join.launches += 1
    return out


_kernel(sorted_join, "sorted_join.cu",
        "link_tpu/ops/pallas_kernels.py:62",
        [_P, _P, _P, _I, _P, _P, _P, _LL, _I, _P])


# --------------------------------------------------------------------------
# gather_conv

_CONV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of gather_conv's fragment-ordered copy of W per (tap, 64 input
# channels, 64 output channels): 4 warps x 8 (tf32) or 4 (bf16) k-steps x
# 32 lanes x 16 bytes (csrc/gather_conv.cu, `w_frag_kernel`)
_CONV_W_FRAG_BYTES = {torch.float32: 16384, torch.bfloat16: 8192}


def conv_w_frag_bytes(k: int, ci: int, co: int, dtype: torch.dtype) -> int:
    """Size of the W scratch one `gather_conv` launch takes."""
    return k * -(-ci // 64) * -(-co // 64) * _CONV_W_FRAG_BYTES[dtype]


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
    w_frag = torch.empty(conv_w_frag_bytes(k, ci, co, feats.dtype),
                         dtype=torch.uint8, device=feats.device)
    rc = _entry(gather_conv)(
        feats.data_ptr(), n, ci, idx.data_ptr(), k, m, weight.data_ptr(), co,
        w_frag.data_ptr(), out.data_ptr(), _CONV_DTYPES[feats.dtype],
        _stream(feats))
    _raise_on("gather_conv", rc)
    gather_conv.launches += 1
    return out


_kernel(gather_conv, "gather_conv.cu",
        "link_tpu/ops/pallas_kernels.py:111",
        [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _I, _P])


# --------------------------------------------------------------------------
# window_conv

WINDOW_MAX_TAPS = 8     # taps per group and window width the kernel takes
WINDOW_MAX_GROUPS = 32  # tap groups the kernel takes (one lane each)
# window rows staged per (16-row tile, group) by the kernel (csrc/
# window_conv.cu, S); a window row past them is read from device memory
WINDOW_SPAN_ROWS = 48
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
    if gw > WINDOW_MAX_TAPS or len(groups) > WINDOW_MAX_GROUPS:
        raise ValueError(f"window_conv: {len(groups)} groups of up to {gw} "
                         f"taps (at most {WINDOW_MAX_GROUPS} of "
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
    rc = _entry(window_conv)(
        feats.data_ptr(), n, ci, base_pos.data_ptr(), slot.data_ptr(), m,
        taps.data_ptr(), goff.data_ptr(), len(groups), k, gw,
        weight.data_ptr(), co, out.data_ptr(), _CONV_DTYPES[feats.dtype],
        _stream(feats))
    _raise_on("window_conv", rc)
    window_conv.launches += 1
    return out


_kernel(window_conv, "window_conv.cu",
        "link_tpu/ops/pallas_kernels.py:179",
        [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P])


# --------------------------------------------------------------------------
# gather_wgrad

WGRAD_ITEM_HITS = 1024   # hits of one tap summed by one work item (<= 2048)


class WgradWork(NamedTuple):
    """Work list of one inverse kernel map bwd_idx (K, N): hit_i and hit_j
    (K * N,) int32 hold the (input row i, output row bwd_idx[k, i]) pairs of
    every hit, tap-major and in row order within a tap, and tap k's pairs
    are [tap_off[k], tap_off[k + 1]) (tap_off (K + 1,) int32). Entries past
    tap_off[K] are unused."""
    hit_i: torch.Tensor
    hit_j: torch.Tensor
    tap_off: torch.Tensor


def wgrad_work_list_plain(bwd_idx: torch.Tensor) -> WgradWork:
    """Plain twin of `wgrad_work_list`: a cumsum over the hits gives each
    its place in the list, and one scatter per array writes it there (the
    misses to a dump slot past the end)."""
    k, n = bwd_idx.shape
    dev = bwd_idx.device
    flat = bwd_idx.reshape(-1)
    hit = flat >= 0
    dest = torch.where(hit, torch.cumsum(hit, 0) - 1, k * n)
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat(k)
    hit_i = torch.zeros(k * n + 1, dtype=torch.int32, device=dev)
    hit_j = torch.zeros(k * n + 1, dtype=torch.int32, device=dev)
    hit_i.scatter_(0, dest, rows)
    hit_j.scatter_(0, dest, flat)
    tap_off = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    tap_off[1:] = torch.cumsum(hit.reshape(k, n).sum(1), 0)
    return WgradWork(hit_i[:k * n], hit_j[:k * n], tap_off)


WORK_LIST_LAUNCHES = 3    # kernels of one `wgrad_work_list` build on the card


def wgrad_work_list(bwd_idx: torch.Tensor) -> WgradWork:
    """The work list of `gather_wgrad` for bwd_idx (K, N) int32, built on
    bwd_idx's device without a host synchronisation: on the card by three
    small kernels of csrc/gather_wgrad.cu (hits counted per 1,024-row chunk,
    the counts scanned, the hits written in row order), on the CPU by its
    plain twin. `wgrad_work_list.builds` counts the builds on the card, of
    WORK_LIST_LAUNCHES launches each."""
    if _on_cpu(bwd_idx):
        return wgrad_work_list_plain(bwd_idx)
    _check_cuda("wgrad_work_list", bwd_idx)
    if bwd_idx.dtype != torch.int32 or bwd_idx.dim() != 2:
        raise ValueError("wgrad_work_list: bwd_idx must be (K, N) int32")
    k, n = bwd_idx.shape
    dev = bwd_idx.device
    hit_i = torch.empty(k * n, dtype=torch.int32, device=dev)
    hit_j = torch.empty(k * n, dtype=torch.int32, device=dev)
    tap_off = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    if k == 0 or n == 0:
        return WgradWork(hit_i, hit_j, tap_off)
    chunks = -(-n // 1024)
    scratch = torch.empty(2 * k * chunks, dtype=torch.int32, device=dev)
    fn = getattr(_lib("gather_wgrad.cu"), "wgrad_work_list")
    fn.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    rc = fn(bwd_idx.data_ptr(), n, k, hit_i.data_ptr(), hit_j.data_ptr(),
            tap_off.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * k * chunks, _stream(bwd_idx))
    _raise_on("wgrad_work_list", rc)
    wgrad_work_list.builds += 1
    return WgradWork(hit_i, hit_j, tap_off)


wgrad_work_list.builds = 0


def gather_wgrad_plain(feats: torch.Tensor, g: torch.Tensor,
                       bwd_idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of `gather_wgrad`: per tap, gather g over the inverse map
    (a miss reads a zero row) and one matmul feats^T @ g_k, products and sum
    in float32."""
    m, co = g.shape
    k = bwd_idx.shape[0]
    f32 = feats.to(torch.float32)
    ext = torch.cat([g, g.new_zeros((1, co))]).to(torch.float32)
    safe = torch.where(bwd_idx >= 0, bwd_idx,
                       torch.full_like(bwd_idx, m)).long()
    return torch.stack([f32.T @ ext[safe[kk]] for kk in range(k)])


def gather_wgrad(feats: torch.Tensor, g: torch.Tensor,
                 bwd_idx: torch.Tensor,
                 work: Optional[WgradWork] = None) -> torch.Tensor:
    """dW[k] = sum_i feats[i]^T (x) g[bwd_idx[k, i]] over bwd_idx[k, i] >= 0:
    the weight gradient of `gather_conv`, with `bwd_idx` the inverse of the
    forward kernel map. feats (N, Ci) and g (M, Co) float32 or bfloat16
    (one dtype), bwd_idx (K, N) int32. `work` is bwd_idx's work list
    (`wgrad_work_list`), built here when not given; a caller that runs
    several weight gradients over one map passes it. Returns (K, Ci, Co)
    float32."""
    if _on_cpu(feats, g, bwd_idx):
        return gather_wgrad_plain(feats, g, bwd_idx)
    _check_cuda("gather_wgrad", feats, g, bwd_idx)
    if feats.dtype not in _CONV_DTYPES or g.dtype != feats.dtype:
        raise ValueError(f"gather_wgrad: dtypes {feats.dtype} and {g.dtype} "
                         "(one of float32, bfloat16 for both)")
    if feats.dim() != 2 or g.dim() != 2:
        raise ValueError("gather_wgrad: feats and g must be 2-D")
    n, ci = feats.shape
    m, co = g.shape
    if (bwd_idx.dtype != torch.int32 or bwd_idx.dim() != 2
            or bwd_idx.shape[1] != n):
        raise ValueError(f"gather_wgrad: bwd_idx must be (K, {n}) int32")
    k = bwd_idx.shape[0]
    out = torch.empty((k, ci, co), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    if work is None:
        work = wgrad_work_list(bwd_idx)
    _check_cuda("gather_wgrad", feats, *work)
    if work.hit_i.numel() != k * n or work.tap_off.numel() != k + 1:
        raise ValueError("gather_wgrad: the work list is not bwd_idx's")
    items = -(-k * n // WGRAD_ITEM_HITS) + k
    partial = torch.empty((items, ci, co), dtype=torch.float32,
                          device=feats.device)
    rc = _entry(gather_wgrad)(
        feats.data_ptr(), n, ci, g.data_ptr(), m, co, work.hit_i.data_ptr(),
        work.hit_j.data_ptr(), work.tap_off.data_ptr(), k, WGRAD_ITEM_HITS,
        items, partial.data_ptr(), out.data_ptr(),
        _CONV_DTYPES[feats.dtype], _stream(feats))
    _raise_on("gather_wgrad", rc)
    gather_wgrad.launches += 1
    return out


_kernel(gather_wgrad, "gather_wgrad.cu",
        "link_tpu/sparse/conv.py:620 (no Pallas counterpart: the XLA "
        "product of _gm_bwd_core)",
        [_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P])


# --------------------------------------------------------------------------
# probes

_PROBE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
SLAB_MAX_BYTES = 232448     # shared memory one block can use on the H100


def probe_row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of `probe_row_gather`: advanced indexing, zero rows for
    indices outside [0, N)."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    rows = x[torch.where(ok, idx, torch.zeros_like(idx)).long()]
    return torch.where(ok.reshape((-1,) + (1,) * (x.dim() - 1)), rows,
                       torch.zeros_like(rows))


def probe_row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[q] = x[idx[q]] for a table x of N rows ((N,) or (N, C); float32,
    bfloat16 or int32) and idx (Q,) int32; an index outside [0, N) gives a
    zero row. The copy is exact."""
    if _on_cpu(x, idx):
        return probe_row_gather_plain(x, idx)
    _check_cuda("probe_row_gather", x, idx)
    if x.dtype not in _PROBE_DTYPES or x.dim() not in (1, 2):
        raise ValueError("probe_row_gather: x must be (N,) or (N, C) "
                         "float32, bfloat16 or int32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("probe_row_gather: idx must be (Q,) int32")
    row_bytes = x.element_size() * (x.shape[1] if x.dim() == 2 else 1)
    q = idx.shape[0]
    out = torch.empty((q,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    rc = _entry(probe_row_gather)(x.data_ptr(), x.shape[0], row_bytes,
                                  idx.data_ptr(), q, out.data_ptr(),
                                  _stream(x))
    _raise_on("probe_row_gather", rc)
    probe_row_gather.launches += 1
    return out


_kernel(probe_row_gather, "probes.cu",
        "tools/probe_mosaic.py:103 (and :126, :161, :189; "
        "tools/probe_mosaic2.py:121, :172)",
        [_P, _I, _I, _P, _LL, _P, _P])


def probe_slab_copy_plain(x: torch.Tensor, offs: torch.Tensor, g: int,
                          out_rows: int = 0) -> torch.Tensor:
    """Plain twin of `probe_slab_copy`: the slices x[off:off + g] stacked (a
    slab that leaves the table reads as zeros), then the first element of
    each (slab mode) or its first `out_rows` rows (window mode)."""
    n = x.shape[0]
    ok = (offs >= 0) & (offs + g <= n)
    rows = (torch.where(ok, offs, torch.zeros_like(offs)).long()[:, None]
            + torch.arange(max(out_rows, 1), device=x.device)[None, :])
    slabs = torch.where(ok[:, None, None], x[rows], torch.zeros_like(x[:1]))
    if out_rows == 0:
        return slabs[:, 0, 0].contiguous()
    return slabs.reshape(-1, x.shape[1])


def probe_slab_copy(x: torch.Tensor, offs: torch.Tensor, g: int,
                    out_rows: int = 0) -> torch.Tensor:
    """Copy the S slabs x[offs[s]:offs[s] + g] through shared memory, one
    block per slab. x (N, C) float32 or int32 with C * 4 a multiple of 16
    bytes, offs (S,) int32, g rows per slab (g * C * 4 bytes at most
    SLAB_MAX_BYTES). out_rows == 0 (slab mode): returns (S,), the first
    element of each slab. out_rows > 0 (window mode, <= g): returns
    (S * out_rows, C), the first out_rows rows of each slab. A slab that
    leaves the table reads as zeros. The copy is exact."""
    if not 0 <= out_rows <= g:
        raise ValueError(f"probe_slab_copy: out_rows {out_rows} for g={g}")
    if _on_cpu(x, offs):
        return probe_slab_copy_plain(x, offs, g, out_rows)
    _check_cuda("probe_slab_copy", x, offs)
    if x.dim() != 2 or x.element_size() != 4 or x.dtype not in _PROBE_DTYPES:
        raise ValueError("probe_slab_copy: x must be (N, C) float32 or int32")
    if offs.dtype != torch.int32 or offs.dim() != 1:
        raise ValueError("probe_slab_copy: offs must be (S,) int32")
    n, c = x.shape
    row_bytes = c * 4
    if row_bytes % 16 or g * row_bytes > SLAB_MAX_BYTES:
        raise ValueError(f"probe_slab_copy: rows of {row_bytes} B x {g} "
                         "(16-byte multiples, at most "
                         f"{SLAB_MAX_BYTES} B a slab)")
    s = offs.shape[0]
    shape = (s,) if out_rows == 0 else (s * out_rows, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if s == 0:
        return out
    rc = _entry(probe_slab_copy)(x.data_ptr(), n, row_bytes, offs.data_ptr(),
                                 s, g, out_rows, out.data_ptr(), _stream(x))
    _raise_on("probe_slab_copy", rc)
    probe_slab_copy.launches += 1
    return out


_kernel(probe_slab_copy, "probes.cu",
        "tools/probe_mosaic.py:224 (and tools/probe_mosaic2.py:212)",
        [_P, _I, _I, _P, _I, _I, _I, _P, _P])


def probe_empty_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of `probe_empty`."""
    return x.clone()


def probe_empty(x: torch.Tensor) -> torch.Tensor:
    """A copy of one (8, 128) float32 tile: the smallest launch."""
    if x.shape != (8, 128) or x.dtype != torch.float32:
        raise ValueError("probe_empty: x must be (8, 128) float32")
    if _on_cpu(x):
        return probe_empty_plain(x)
    _check_cuda("probe_empty", x)
    out = torch.empty_like(x)
    rc = _entry(probe_empty)(x.data_ptr(), out.data_ptr(), _stream(x))
    _raise_on("probe_empty", rc)
    probe_empty.launches += 1
    return out


_kernel(probe_empty, "probes.cu", "tools/probe_mosaic2.py:97", [_P, _P, _P])

KERNELS = tuple(KERNELS)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    wgrad_work_list.builds = 0
