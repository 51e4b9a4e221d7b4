"""Hand-written Hopper kernels of the port, with their plain twins.

Eight kernels. Three are ports of the Pallas kernels of
`link_tpu/ops/pallas_kernels.py`:

  * `sorted_join` (csrc/sorted_join.cu) replaces `pallas_join` (:62-89)
    and the XLA fusion that forms its queries: each query is
    pack(base * mult + offset), formed in the kernel from the base rows and
    the tap offsets, and joined against a sorted key table, in three modes:
    the exact hit (perm[pos] or -1), the lower bound itself, and the window
    form's (in_idx, base_pos, slot) of `grouped_window_query`.
  * `gather_conv` (csrc/gather_conv.cu) replaces `pallas_sparse_conv`
    (:111-144): out[m] = sum_k feats[idx[k, m]] @ W[k], float32
    accumulation, idx -1 reads a zero row. In training it also computes the
    feature gradient, over the inverse kernel map with W[k]^T.
  * `window_conv` (csrc/window_conv.cu) replaces `onehot_window_conv`
    (:179-276): the same sum with input rows addressed as base_pos[g, m] +
    slot[t, m] for tap t of group g. In training it also computes the
    feature gradient of a window-form submanifold conv, over the plan's own
    windows with W[mirror[t]]^T.

Two have no Pallas counterpart:

  * `gather_wgrad` (csrc/gather_wgrad.cu) replaces the XLA product of
    `_gm_bwd_core` (link_tpu/sparse/conv.py:608-622): the weight gradient
    dW[k] = sum_i feats[i]^T (x) g[bwd_idx[k, i]], without the gathered
    copy of g.
  * `rotated_nms` (csrc/rotated_nms.cu) replaces `rotate_nms_jax`
    (link_tpu/ops/nms.py:171): the keep mask of rotated BEV NMS over a
    fixed-size candidate set, or over S such sets in one call, on the det
    serving path with device NMS (one call per frame).

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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

INT32_MAX = 2**31 - 1

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sorted_join.cu", "gather_conv.cu", "window_conv.cu",
           "gather_wgrad.cu", "probes.cu", "rotated_nms.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
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


# Builds of a source with extra -D defines, each a library of its own
# (named by the defines too), which an instrument loads through
# `_lib(source, defines)`: rotated_nms.cu with every clipped pair sent
# through its overflow redo.
CLIP_REDO = ("rotated_nms.cu", ("ROTATED_NMS_CLIP_REDO",))
VARIANTS = (CLIP_REDO,)


def _so_path(src: str, csrc: Path = CSRC, defines: Tuple[str, ...] = ()
             ) -> Path:
    """The library of one source, named by a hash of the source, every
    header of `csrc` (a quoted #include finds them beside the source), the
    flags and the defines, so that editing any of them builds anew."""
    h = hashlib.sha1((csrc / src).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update((" " + " ".join(f"-D{d}" for d in defines)).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source, and every build of `VARIANTS`, that has
    no up-to-date library, one nvcc process per library, all started
    together. Returns {source or "source -Ddefine": compiler output} for
    the libraries built by this call (ptxas register and shared memory
    report)."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src, defines in [(s, ()) for s in SOURCES] + list(VARIANTS):
            so = _so_path(src, defines=defines)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            flags = [f"-D{d}" for d in defines]
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                   str(CSRC / src)]
            procs[" ".join([src, *flags])] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, so)
        logs = {}
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return logs


def _lib(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of one source (or of its build with `defines`,
    one of `VARIANTS`), with the argument types of every registered entry
    point in it."""
    lib = _libs.get((source, defines))
    if lib is None:
        build_kernels()
        lib = ctypes.CDLL(str(_so_path(source, defines=defines)))
        for wrapper in KERNELS:
            if wrapper.source == source:
                fn = getattr(lib, wrapper.__name__)
                fn.argtypes = wrapper.argtypes
                fn.restype = ctypes.c_int
        _libs[(source, defines)] = lib
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

# Coordinate packing (link_tpu/sparse/coords.py:pack_coords), the rule by
# which `sorted_join` forms its queries. x, y in [-OFFSET_XY, 2^14 -
# OFFSET_XY), z in [-OFFSET_Z, 2^12 - OFFSET_Z), batch >= 0; anything else
# packs to (INT32_MAX, INT32_MAX).
X_BITS = 14
Y_BITS = 14
Z_BITS = 12
OFFSET_XY = 512  # shift applied so slightly-negative probes stay packable
OFFSET_Z = 512
SPAN_X = 1 << X_BITS
SPAN_Y = 1 << Y_BITS
SPAN_Z = 1 << Z_BITS


def pack_coords(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack (N, 4) int32 (x, y, z, b) coords into an order-preserving int32
    key pair (hi, lo). Out-of-range / sentinel coords map to (INT32_MAX,
    INT32_MAX). Sort order of (hi, lo) is lexicographic (b, z, y, x)."""
    x = coords[:, 0] + OFFSET_XY
    y = coords[:, 1] + OFFSET_XY
    z = coords[:, 2] + OFFSET_Z
    b = coords[:, 3]
    valid = ((x >= 0) & (x < SPAN_X) & (y >= 0) & (y < SPAN_Y)
             & (z >= 0) & (z < SPAN_Z) & (b >= 0))
    hi = (b << Z_BITS) | (z & (SPAN_Z - 1))
    lo = (y << X_BITS) | (x & (SPAN_X - 1))
    sent = torch.full_like(hi, INT32_MAX)
    hi = torch.where(valid, hi, sent).to(torch.int32)
    lo = torch.where(valid, lo, sent).to(torch.int32)
    return hi, lo


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key per (hi, lo) pair. lo is never negative, so the int64
    order equals the lexicographic (hi, lo) order."""
    return hi.to(torch.int64) * (2**31) + lo.to(torch.int64)


def offset_groups(offsets):
    """Group tap offsets by (dy, dz); members ordered by x. Returns
    [((ox0, oy, oz), [(ox, tap_id), ...]), ...] in first-appearance order of
    the (dy, dz) pairs (link_tpu/sparse/coords.py:931-943)."""
    groups = {}
    for t, (ox, oy, oz) in enumerate(_offset_rows(offsets)):
        groups.setdefault((oy, oz), []).append((ox, t))
    glist = []
    for (oy, oz), taps in groups.items():
        taps = sorted(taps)
        glist.append(((taps[0][0], oy, oz), taps))
    return glist


def _offset_rows(offsets) -> Tuple[Tuple[int, int, int], ...]:
    rows = tuple(tuple(int(v) for v in o) for o in offsets)
    if not rows or any(len(o) != 3 for o in rows):
        raise ValueError("sorted_join: offsets must be K >= 1 rows of 3")
    return rows


JOIN_MAX_TAPS = 128     # offsets one launch takes (csrc/sorted_join.cu)
JOIN_MAX_GROUPS = 64    # (dy, dz) groups one launch takes
JOIN_BLOCK_WARPS = 8    # warps per block (the window form's scratch)
_JOIN_MODES = {"exact": 0, "lower_bound": 1, "window": 2}
_ZERO_TAP = ((0, 0, 0),)


def _check_mode(mode: str) -> None:
    if mode not in _JOIN_MODES:
        raise ValueError(f"sorted_join: mode {mode!r} (exact, lower_bound, "
                         "window)")


@functools.lru_cache(maxsize=None)
def _join_taps(offsets: tuple, mult: tuple, mode: str):
    """(groups, host int32 array) of one launch: the taps grouped as the
    kernel walks them (by (dy, dz), x ascending; in mode "lower_bound" each
    offset alone, in order) and the parameter block the C entry reads: k,
    g, mult, gstart[0..g], order[0..k), off[0..k) x 3. Cached per
    (offsets, mult, mode), so no launch builds it anew."""
    if mode == "lower_bound":
        groups = [(o, [(o[0], t)]) for t, o in enumerate(offsets)]
    else:
        groups = offset_groups(offsets)
    k, g = len(offsets), len(groups)
    if k > JOIN_MAX_TAPS or g > JOIN_MAX_GROUPS:
        raise ValueError(f"sorted_join: {k} offsets in {g} groups (at most "
                         f"{JOIN_MAX_TAPS} in {JOIN_MAX_GROUPS})")
    gstart, order = [0], []
    for _, taps in groups:
        order += [t for _, t in taps]
        gstart.append(len(order))
    vals = [k, g, *mult, *gstart, *order]
    for t in order:
        vals += offsets[t]
    return groups, (ctypes.c_int * len(vals))(*vals)


def sorted_join_plain(t_hi: torch.Tensor, t_lo: torch.Tensor,
                      perm: torch.Tensor, base: torch.Tensor, offsets=None,
                      mult=None, mode: str = "exact"):
    """Plain twin of `sorted_join`: the queries by `pack_coords` over
    base * mult + offset, int64 keys, `torch.searchsorted` for the lower
    bound, then the hit test, the clamp, and in mode "window" the group
    anchors' bounds, their pinning and the slots."""
    _check_mode(mode)
    offs = _ZERO_TAP if offsets is None else _offset_rows(offsets)
    lead = base.shape[:-1]
    base = base.reshape(-1, 4)
    k, m, n = len(offs), base.shape[0], t_hi.shape[0]
    dev = base.device
    groups = (offset_groups(offs) if mode == "window" else None)
    if n == 0:
        full = torch.full((k, m), -1, dtype=torch.int32, device=dev)
        if mode == "window":
            return (full, torch.full((len(groups), m), -1, dtype=torch.int32,
                                     device=dev), full.to(torch.int8))
        return full.reshape((k,) + lead if offsets is not None else lead)
    tkey = key64(t_hi, t_lo)

    def search(rows):
        o = torch.tensor(rows, dtype=torch.int32, device=dev)
        xyz = base[:, :3]
        if mult is not None:
            xyz = xyz * torch.tensor(mult, dtype=torch.int32, device=dev)
        q = torch.cat([xyz[None] + o[:, None],
                       base[None, :, 3:].expand(len(rows), -1, -1)], -1)
        q_hi, q_lo = pack_coords(q.reshape(-1, 4))
        qkey = key64(q_hi, q_lo)
        pos = torch.searchsorted(tkey, qkey).clamp_(max=n - 1)
        return q_hi, qkey, pos

    if mode == "lower_bound":
        pos = search(offs)[2].to(torch.int32).reshape(k, m)
        return pos.reshape((k,) + lead if offsets is not None else lead)
    q_hi, qkey, pos = search(offs)
    hit = (tkey[pos] == qkey) & (q_hi != INT32_MAX)
    in_idx = torch.where(hit, perm[pos], torch.full_like(q_hi, -1))
    in_idx = in_idx.reshape(k, m)
    if mode == "exact":
        return in_idx.reshape((k,) + lead if offsets is not None else lead)
    # window: one lower bound per (dy, dz) group at its smallest x; padding
    # anchors sort last and would clamp to n - 1, so they are pinned to the
    # group's last valid base (link_tpu/sparse/coords.py:1089-1096)
    a_hi, _, apos = search([a for a, _ in groups])
    g = len(groups)
    apos = apos.to(torch.int32).reshape(g, m)
    valid = a_hi.reshape(g, m) != INT32_MAX
    last_valid = torch.where(valid, apos, torch.zeros_like(apos)).amax(
        dim=1, keepdim=True)
    base_pos = torch.where(valid, apos, last_valid)
    tap_g = [0] * k
    for gi, (_, taps) in enumerate(groups):
        for _, t in taps:
            tap_g[t] = gi
    tb = base_pos.long()[torch.tensor(tap_g, device=dev)]     # (K, M)
    slot = torch.where(in_idx >= 0, in_idx.long() - tb, -1)
    return in_idx, base_pos.contiguous(), slot.to(torch.int8)


def sorted_join(t_hi: torch.Tensor, t_lo: torch.Tensor, perm: torch.Tensor,
                base: torch.Tensor, offsets=None, mult=None,
                mode: str = "exact"):
    """Join of the queries pack(base * mult + offset) against a table of
    (hi, lo) keys sorted lexicographically, perm (N,) the original row of
    each table row; all int32. base (..., 4) (x, y, z, b) rows; offsets K
    rows (dx, dy, dz) of host integers (at most JOIN_MAX_TAPS), or None for
    one zero offset; mult an optional (mx, my, mz) on the base xyz. The
    queries are formed in the kernel: no query, offset or anchor array is
    made on the device.

    mode "exact": (K, ...) int32, perm[lower bound] on an exact match,
    else -1; a query that packs to hi == INT32_MAX misses. mode
    "lower_bound": (K, ...) the lower bounds themselves, clamped to n - 1.
    mode "window" (base (M, 4); offsets grouped by (dy, dz) as
    `offset_groups`): (in_idx (K, M) as "exact", base_pos (G, M) int32 the
    lower bound of each group's smallest-x offset clamped to n - 1, with a
    padding anchor pinned to the group's largest valid base, slot (K, M)
    int8 in_idx - base_pos of the tap's group on a hit, else -1): the
    window-form plan of `link_tpu`'s grouped_window_query. With offsets
    None the leading axis K is left out. One launch (two in mode "window",
    the second pinning the padding anchors)."""
    _check_mode(mode)
    if _on_cpu(t_hi, t_lo, perm, base):
        return sorted_join_plain(t_hi, t_lo, perm, base, offsets, mult, mode)
    _check_cuda("sorted_join", t_hi, t_lo, perm, base)
    for t in (t_hi, t_lo, perm, base):
        if t.dtype != torch.int32:
            raise ValueError("sorted_join: operands must be int32")
    if t_hi.dim() != 1 or base.shape[-1:] != (4,):
        raise ValueError("sorted_join: table (N,), base (..., 4)")
    lead = base.shape[:-1]
    base = base.reshape(-1, 4)
    n, m = t_hi.shape[0], base.shape[0]
    if t_lo.shape != (n,) or perm.shape != (n,):
        raise ValueError("sorted_join: mismatched table lengths")
    if mode == "window" and (offsets is None or len(lead) != 1):
        raise ValueError("sorted_join: mode window takes base (M, 4) and "
                         "offsets")
    if base.data_ptr() % 16:
        raise ValueError("sorted_join: base rows must be 16-byte aligned")
    offs = _ZERO_TAP if offsets is None else _offset_rows(offsets)
    mul = (1, 1, 1) if mult is None else tuple(int(v) for v in mult)
    groups, params = _join_taps(offs, mul, mode)
    k, g = len(offs), len(groups)
    dev = base.device
    out = torch.empty((k, m), dtype=torch.int32, device=dev)
    base_pos = slot = partial = None
    if mode == "window":
        base_pos = torch.empty((g, m), dtype=torch.int32, device=dev)
        slot = torch.empty((k, m), dtype=torch.int8, device=dev)
    if n == 0:
        out.fill_(-1)
        if mode == "window":
            return out, base_pos.fill_(-1), slot.fill_(-1)
    elif m > 0:
        if mode == "window":
            # the kernel's blocks: 32-row tiles, each over up to g warps
            blocks = -(-(-(-m // 32) * g) // JOIN_BLOCK_WARPS)
            partial = torch.empty(blocks * (g + 1), dtype=torch.int32,
                                  device=dev)
        rc = _entry(sorted_join)(
            t_hi.data_ptr(), t_lo.data_ptr(), perm.data_ptr(), n,
            base.data_ptr(), m, params, _JOIN_MODES[mode], out.data_ptr(),
            None if base_pos is None else base_pos.data_ptr(),
            None if slot is None else slot.data_ptr(),
            None if partial is None else partial.data_ptr(), _stream(base))
        _raise_on("sorted_join", rc)
        sorted_join.launches += 1
    if mode == "window":
        return out, base_pos, slot
    return out.view((k,) + lead if offsets is not None else lead)


_kernel(sorted_join, "sorted_join.cu",
        "link_tpu/ops/pallas_kernels.py:62",
        [_P, _P, _P, _I, _P, _I, ctypes.POINTER(ctypes.c_int), _I, _P, _P,
         _P, _P, _P])


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
    partial = torch.empty((items, ci, co), dtype=torch.float64,
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
    """Stage the S slabs x[offs[s]:offs[s] + g] in full through shared
    memory (TMA bulk copies into a ring of stages; a slab of any size, cut
    into chunks of one stage). x (N, C) float32 or int32 with C * 4 a
    multiple of 16 bytes, offs (S,) int32, g rows per slab. out_rows == 0
    (slab mode): returns (S,), the first element of each slab. out_rows > 0
    (window mode, <= g): returns (S * out_rows, C), the first out_rows rows
    of each slab. A slab that leaves the table reads as zeros. The copy is
    exact."""
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
    if row_bytes % 16:
        raise ValueError(f"probe_slab_copy: rows of {row_bytes} B (16-byte "
                         "multiples)")
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


# --------------------------------------------------------------------------
# rotated_nms

NMS_MAX_N = 8192            # candidates per set one call takes
NMS_TILE = 64               # ranks per mask tile side: one 64-bit word
NMS_PLANES = 12             # doubles of one box in the scratch
ROTATED_NMS_LAUNCHES = 3    # kernels of one call: ranks and boxes, the pair
#                             mask, the walk (every set in each)


def _nms_scratch_bytes(sets: int, n: int) -> int:
    """Bytes of `rotated_nms`'s scratch (csrc/rotated_nms.cu, `carve`): the
    mask (S, N, words) uint64, the boxes (S, 12, N) float64 in rank order,
    order (S, N) int32 and the valid counts (S,) int32."""
    words = -(-n // NMS_TILE)
    return sets * n * (words * 8 + NMS_PLANES * 8 + 4) + sets * 4


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, thresh: float,
                max_keep: int) -> torch.Tensor:
    """Rotated BEV NMS over one candidate set, boxes (N, 5) float32
    [x y w l r], scores (N,) float32, valid (N,) bool, or over S sets of
    the same N at once (boxes (S, N, 5), scores and valid (S, N)). Returns
    the keep mask of the same shape as scores, bool, in input order: per
    set at most max_keep kept, with priority by descending score (ties by
    the lower index); a pair overlaps when its BEV IoU exceeds thresh. The
    plain twin is `nms.rotate_nms_device`. Three launches for all sets; no
    sort, copy or synchronization outside them."""
    if _on_cpu(boxes, scores, valid):
        from .nms import rotate_nms_device
        return rotate_nms_device(boxes, scores, valid, thresh, max_keep)
    keep = _rotated_nms_call(lambda: _entry(rotated_nms), boxes, scores,
                             valid, thresh, max_keep)
    rotated_nms.launches += ROTATED_NMS_LAUNCHES
    return keep


def _rotated_nms_call(entry, boxes, scores, valid, thresh, max_keep):
    """Check `rotated_nms`'s inputs and launch the C entry that `entry()`
    returns (loaded after the checks)."""
    _check_cuda("rotated_nms", boxes, scores, valid)
    if scores.dim() not in (1, 2):
        raise ValueError("rotated_nms: scores (N,) or (S, N)")
    sets = 1 if scores.dim() == 1 else scores.shape[0]
    n = scores.shape[-1]
    if (boxes.dtype != torch.float32 or scores.dtype != torch.float32
            or valid.dtype != torch.bool
            or boxes.shape != (*scores.shape, 5)
            or valid.shape != scores.shape):
        raise ValueError("rotated_nms: boxes ([S,] N, 5) float32, scores "
                         "([S,] N) float32, valid ([S,] N) bool")
    if n > NMS_MAX_N:
        raise ValueError(f"rotated_nms: {n} candidates > {NMS_MAX_N}")
    keep = torch.empty(scores.shape, dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    nbytes = _nms_scratch_bytes(sets, n)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=boxes.device)
    _raise_on("rotated_nms", entry()(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), sets, n,
        float(thresh), max(0, min(int(max_keep), n)), scratch.data_ptr(),
        nbytes, keep.data_ptr(), _stream(boxes)))
    return keep


_kernel(rotated_nms, "rotated_nms.cu",
        "link_tpu/ops/nms.py:171 (no Pallas counterpart: rotate_nms_jax "
        "runs in XLA)",
        [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P, _LL, _P, _P])


def rotated_nms_clip_redo(boxes: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor, thresh: float,
                          max_keep: int) -> torch.Tensor:
    """`rotated_nms` from its build with -DROTATED_NMS_CLIP_REDO
    (`CLIP_REDO`), which sends every clipped pair through the overflow
    redo (`clip_area_slow`) instead of the 8-vertex clip: an instrument
    for holding that redo against the normal build. CUDA tensors only; no
    path calls it, and it counts no launch."""
    return _rotated_nms_call(lambda: _lib(*CLIP_REDO).rotated_nms, boxes,
                             scores, valid, thresh, max_keep)


def rotated_nms_iou(boxes: torch.Tensor,
                    clip_redo: bool = False) -> torch.Tensor:
    """The BEV IoU matrix (N, N) float64 of (N, 5) float32 boxes on the
    card, from the tile code whose IoU `rotated_nms` thresholds (row i the
    clip's subject, column j the clip quad), in input order and over every
    pair. An instrument for holding the kernel's IoU against
    `nms.rotated_iou_bev` and `native.bev_iou`; no path calls it, and it
    counts no launch. `clip_redo`: from the `CLIP_REDO` build."""
    _check_cuda("rotated_nms_iou", boxes)
    n = boxes.shape[0]
    if boxes.dtype != torch.float32 or boxes.shape != (n, 5) \
            or not 0 < n <= NMS_MAX_N:
        raise ValueError("rotated_nms_iou: boxes (N, 5) float32, "
                         f"0 < N <= {NMS_MAX_N}")
    out = torch.empty((n, n), dtype=torch.float64, device=boxes.device)
    fn = _lib(*(CLIP_REDO if clip_redo else ("rotated_nms.cu",))
              ).rotated_nms_iou
    fn.argtypes = [_P, _I, _P, _P]
    fn.restype = ctypes.c_int
    _raise_on("rotated_nms_iou",
              fn(boxes.data_ptr(), n, out.data_ptr(), _stream(boxes)))
    return out


KERNELS = tuple(KERNELS)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    wgrad_work_list.builds = 0
