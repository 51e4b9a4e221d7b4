"""The port's probe twins against the TPU probe kernels, run in Pallas's
interpret mode on the CPU.

The Mosaic probes of tools/probe_mosaic.py and tools/probe_mosaic2.py are
closures inside their `main()` and cannot be imported, so each kernel body
below is copied from its file (file:line beside it) and called through
`pl.pallas_call(..., interpret=True)` with the TPU probe's own specs: the
DMA slab copy (`make_async_copy` on a DMA semaphore), the scalar-prefetched
window fetch (`PrefetchScalarGridSpec`), the row take, the 1-D gather, the
one-hot MXU gather, take_along_axis and the lane gather. The same numpy
inputs, made from a seed, go through the port's plain twins
(`probe_slab_copy_plain`, `probe_row_gather_plain`), which the CUDA kernels
are held to bit for bit on the card; here the two must agree exactly. The
port's zero slab for an offset outside the table has no TPU counterpart (a
DMA there would fault), so it stays with the twin tests of
tests/test_torch_train_tools.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from link_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _table(rng, shape, dtype):
    if dtype == "int32":
        return rng.integers(0, 1 << 30, size=shape).astype(np.int32)
    return np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


def _vmem_call(kern, out_shape, *args):
    """The probes' whole-array VMEM call, interpreted."""
    return np.asarray(pl.pallas_call(
        kern, out_shape=out_shape,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(*args))


# --------------------------------------------------------------------------
# probe_slab_copy


@pytest.mark.parametrize("g,nslabs", [(1, 9), (8, 5), (64, 7), (500, 3)])
def test_probe_dma_vs_slab_mode(g, nslabs):
    """probe_dma (tools/probe_mosaic.py:208-238): each slab copied HBM ->
    VMEM by make_async_copy, its first element summed in slab order. The
    port's slab mode returns each slab's first element; summed in the same
    order in float32 they must give the TPU kernel's sum exactly."""
    rng = np.random.default_rng(g)
    n, c = 512, 64
    x = _table(rng, (n, c), "float32")
    offs = rng.integers(0, n - g, size=(nslabs,)).astype(np.int32)

    # tools/probe_mosaic.py:212-220
    def kern(offs_ref, x_hbm, o_ref, scratch, sem):
        def body(i, acc):
            off = offs_ref[i]
            cp = pltpu.make_async_copy(
                x_hbm.at[pl.ds(off, g), :], scratch, sem)
            cp.start()
            cp.wait()
            return acc + scratch[0, 0].astype(jnp.float32)
        o_ref[0, 0] = jax.lax.fori_loop(0, nslabs, body, jnp.float32(0))

    # tools/probe_mosaic.py:224-231
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.VMEM((g, c), jnp.float32),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(jnp.asarray(offs), jnp.asarray(x))

    firsts = kernels.probe_slab_copy_plain(_torch(x), _torch(offs), g).numpy()
    assert firsts.shape == (nslabs,)
    assert np.array_equal(firsts, x[offs, 0])
    acc = np.float32(0)
    for v in firsts:
        acc = np.float32(acc + v)
    assert np.asarray(out)[0, 0] == acc


@pytest.mark.parametrize("bw,bq", [(8, 8), (32, 8), (128, 8), (64, 64)])
def test_probe_pref_vs_window_mode(bw, bq):
    """probe_pref (tools/probe_mosaic2.py:192-216): a grid over Q / BQ
    output blocks, each fetching the (BW, C) window at a scalar-prefetched
    block index and writing its first BQ rows: the port's window mode with
    offsets = block index * BW and out_rows = BQ."""
    rng = np.random.default_rng(bw * 1000 + bq)
    n, c, dtype = 512, 64, jnp.float32
    q = 6 * bq
    x = _table(rng, (n, c), "float32")
    nblk = q // bq
    wb = rng.integers(0, n // bw, size=(nblk,)).astype(np.int32)

    # tools/probe_mosaic2.py:198-208
    def kern(wb_ref, xw_ref, o_ref):
        o_ref[:] = xw_ref[0:bq, :]

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nblk,),
        in_specs=[pl.BlockSpec((bw, c), lambda i, wb_ref: (wb_ref[i], 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((bq, c), lambda i, wb_ref: (i, 0),
                               memory_space=pltpu.VMEM),
    )
    # tools/probe_mosaic2.py:212-215
    out = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((q, c), dtype),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(wb), jnp.asarray(x)))

    got = kernels.probe_slab_copy_plain(_torch(x), _torch(wb * bw), bw, bq)
    assert np.array_equal(got.numpy(), out)


# --------------------------------------------------------------------------
# probe_row_gather


@pytest.mark.parametrize("n,c,q,dtype", [(256, 128, 300, "float32"),
                                         (64, 64, 200, "bfloat16"),
                                         (512, 8, 64, "float32")])
def test_row_take_vs_row_gather(n, c, q, dtype):
    """The row take (tools/probe_mosaic.py:94-115, and check_row_gather
    :117-131): jnp.take(x, idx, axis=0) with table and index in VMEM."""
    rng = np.random.default_rng(n + c + q)
    x = _table(rng, (n, c), dtype)
    idx = rng.integers(0, n, size=(q,)).astype(np.int32)

    # tools/probe_mosaic.py:98-99
    def kern(idx_ref, x_ref, o_ref):
        o_ref[:] = jnp.take(x_ref[:], idx_ref[:], axis=0)

    out = _vmem_call(kern, jax.ShapeDtypeStruct((q, c), dtype),
                     jnp.asarray(idx), jnp.asarray(x))
    got = _numpy(kernels.probe_row_gather_plain(_torch(x), _torch(idx)))
    assert got.dtype == out.dtype and np.array_equal(
        got.view(np.uint8), out.view(np.uint8))


def test_1d_gather_vs_row_gather():
    """The 1-D gather kern1d (tools/probe_mosaic.py:151-167) on int32."""
    rng = np.random.default_rng(7)
    n, q = 500, 480
    t = _table(rng, (n,), "int32")
    idx = rng.integers(0, n, size=(q,)).astype(np.int32)

    # tools/probe_mosaic.py:156-157
    def kern1d(idx_ref, t_ref, o_ref):
        o_ref[:] = jnp.take(t_ref[:], idx_ref[:], axis=0)

    out = _vmem_call(kern1d, jax.ShapeDtypeStruct((q,), jnp.int32),
                     jnp.asarray(idx), jnp.asarray(t))
    got = kernels.probe_row_gather_plain(_torch(t), _torch(idx)).numpy()
    assert np.array_equal(got, out)


@pytest.mark.parametrize("l,c,qb", [(256, 128, 128), (128, 64, 256)])
def test_onehot_gather_vs_row_gather(l, c, qb):
    """probe_onehot (tools/probe_mosaic.py:176-189): onehot(idx) @ X in
    bfloat16 with a float32 sum, which holds one product per output and so
    equals the row exactly."""
    rng = np.random.default_rng(l + qb)
    dtype = jnp.bfloat16
    x = _table(rng, (l, c), dtype)
    idx = rng.integers(0, l, size=(qb,)).astype(np.int32)

    # tools/probe_mosaic.py:180-185
    def kern(idx_ref, x_ref, o_ref):
        cols = jax.lax.broadcasted_iota(jnp.int32, (qb, l), 1)
        oh = (cols == idx_ref[:].reshape(qb, 1)).astype(dtype)
        o_ref[:] = jnp.dot(oh, x_ref[:],
                           preferred_element_type=jnp.float32
                           ).astype(dtype)

    out = _vmem_call(kern, jax.ShapeDtypeStruct((qb, c), dtype),
                     jnp.asarray(idx), jnp.asarray(x))
    got = _numpy(kernels.probe_row_gather_plain(_torch(x), _torch(idx)))
    assert np.array_equal(got.view(np.uint16), out.view(np.uint16))


@pytest.mark.parametrize("n,c,q,dtype", [(64, 128, 100, "float32"),
                                         (96, 8, 40, "bfloat16")])
def test_take_along_axis_vs_row_gather(n, c, q, dtype):
    """probe_tal (tools/probe_mosaic2.py:110-121): take_along_axis over
    rows with the index broadcast along the lanes."""
    rng = np.random.default_rng(n * c)
    x = _table(rng, (n, c), dtype)
    idx = rng.integers(0, n, size=(q,)).astype(np.int32)

    # tools/probe_mosaic2.py:115-118
    def kern(idx_ref, x_ref, o_ref):
        idx2d = jnp.broadcast_to(idx_ref[:].reshape(-1, 1),
                                 (idx_ref.shape[0], x_ref.shape[1]))
        o_ref[:] = jnp.take_along_axis(x_ref[:], idx2d, axis=0)

    out = _vmem_call(kern, jax.ShapeDtypeStruct((q, c), dtype),
                     jnp.asarray(idx), jnp.asarray(x))
    got = _numpy(kernels.probe_row_gather_plain(_torch(x), _torch(idx)))
    assert np.array_equal(got.view(np.uint8), out.view(np.uint8))


@pytest.mark.parametrize("n,q", [(256, 256), (128, 300)])
def test_lane_gather_vs_flat_row_gather(n, q):
    """The lane gather (tools/probe_mosaic2.py:162-184): out[r, j] =
    x[r, idx[r, j]] over (8, n), which the port's probe runs as a 1-D row
    gather of x.reshape(-1) at r * n + idx[r, j] (the probe tool's A3)."""
    rng = np.random.default_rng(n + q)
    x = _table(rng, (8, n), "float32")
    idxn = rng.integers(0, n, size=(8, q)).astype(np.int32)

    # tools/probe_mosaic2.py:168-169
    def kern(idx_ref, x_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=1)

    out = _vmem_call(kern, jax.ShapeDtypeStruct((8, q), jnp.float32),
                     jnp.asarray(idxn), jnp.asarray(x))
    flat = (np.arange(8)[:, None] * n + idxn).reshape(-1).astype(np.int32)
    got = kernels.probe_row_gather_plain(_torch(x.reshape(-1)),
                                         _torch(flat)).numpy()
    assert np.array_equal(got.reshape(8, q), out)
