"""The port's ELKEncoder training step against the JAX package's, leaf by
leaf (tests/torch_train_family.py has the setup), through each of the ELK
block's aux paths:
  * "sparse": the aux blocks joined by sorted keys (no grid extent), at the
    golden's r=3, s=5, groups 2, cos (tests/test_golden_parity.py:113-114);
  * "dense": the same model with the batch's own extent, so that every one
    of the four levels takes `elk_aux_window_dense`;
  * "grid_extent": the bench's training configuration (bench.py:404), the
    config's r=3, s=7, groups 2, cos with `grid_extent(voxel, batch)`, the
    batch collated against the same extent.
The three loss parts within 1e-6; every gradient, parameter and batch
statistic after the step within 5e-4 of its leaf's largest magnitude
(float32 on both sides; the ELK window's sums of cosines of the
coordinates, in another order, move the gradients by up to ~1e-4).
"""

import numpy as np
import pytest

from link_tpu.models.linkencoder import ELKEncoder as JELKEncoder
from link_tpu.utils.torch_import import translate_elkencoder
from link_tpu_torch.data.semantic_kitti import grid_extent
from link_tpu_torch.models.linkencoder import ELKEncoder
from link_tpu_torch.ops.elk import use_dense_aux
from link_tpu_torch.sparse.tensor import make_sparse_tensor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_family import (CAPS, CR, batch, check_grads, check_loss,
                                check_state, generator, run_both)

TOL = 5e-4
GOLDEN_ARCH = dict(r=3, s=5, groups=2, baseop="cos")
CONFIG_ARCH = dict(r=3, s=7, groups=2, baseop="cos")   # linkencoder/default.yaml
VARIANTS = ("sparse", "dense", "grid_extent")


def _setup(variant):
    """(arch, grid extent, batch) of a variant."""
    if variant == "grid_extent":
        ext = grid_extent(0.4, batch_size=2)
        return CONFIG_ARCH, ext, batch(grid_extent=ext)
    b = batch()
    c = b["coords"][:int(b["nnz"])]
    ext = (tuple(int(v) for v in c[:, :3].max(0) + 1) + (2,)
           if variant == "dense" else None)
    return GOLDEN_ARCH, ext, b


def _aux_paths(model, b):
    """The aux path each ELK level takes on batch `b`."""
    st = make_sparse_tensor(b["feats"], b["coords"], nnz=b["nnz"],
                            base_sorted=True, grid_extent=model.grid_extent,
                            device="cpu")
    paths = []
    for lvl in range(1, 5):
        block = getattr(model, f"elk{lvl}")
        gs = use_dense_aux(st, (1 << lvl) * model.s, model.r, 2 * block.inc)
        paths.append("sparse" if gs is None else "dense")
    return paths


@pytest.fixture(scope="module", params=VARIANTS)
def out(request):
    arch, ext, b = _setup(request.param)
    port = ELKEncoder(20, cr=CR, capacities=CAPS, grid_extent=ext,
                      device="cpu", generator=generator(), **arch)
    paths = _aux_paths(port, b)
    want = "sparse" if request.param == "sparse" else "dense"
    assert paths == [want] * 4, paths
    if request.param == "grid_extent":
        assert int(b["nnz"]) > 250 and (b["coords"][:int(b["nnz"]), :3]
                                        < np.asarray(ext[:3])).all()
    return run_both(port, JELKEncoder(num_classes=20, cr=CR, capacities=CAPS,
                                      grid_extent=ext, **arch),
                    translate_elkencoder, b)


def test_elkencoder_train_loss_matches_jax(out):
    check_loss(out)


def test_elkencoder_gradients_match_jax(out):
    check_grads(out, TOL)


def test_elkencoder_parameters_and_batch_stats_after_a_step_match_jax(out):
    check_state(out, TOL)
