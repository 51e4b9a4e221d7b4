"""The kernel libraries' names (link_tpu_torch/ops/kernels.py, `_so_path`).

A library is named by a hash of its source, of every shared header of
csrc/ and of the nvcc flags, so that an edited header builds anew instead
of loading a stale library. Checked on a temporary copy of csrc/: no
compiler is needed.
"""

import shutil

import pytest

from link_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, dst)
    return dst


def paths(csrc):
    return {src: kernels._so_path(src, csrc) for src in kernels.SOURCES}


def test_a_copy_of_the_sources_names_the_same_libraries(csrc_copy):
    assert paths(csrc_copy) == paths(kernels.CSRC)
    for src, so in paths(csrc_copy).items():
        assert so.parent == kernels.BUILD_DIR and so.suffix == ".so"
        assert so.name.startswith(src.split(".")[0] + "-")


def test_editing_the_shared_header_renames_its_users(csrc_copy):
    before = paths(csrc_copy)
    header = csrc_copy / "mma_sm90.cuh"
    assert header.exists()
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = paths(csrc_copy)
    for src in ("gather_conv.cu", "gather_wgrad.cu"):
        assert '#include "mma_sm90.cuh"' in (csrc_copy / src).read_text()
        assert after[src] != before[src]


def test_editing_one_source_renames_only_its_library(csrc_copy):
    before = paths(csrc_copy)
    src = csrc_copy / "window_conv.cu"
    src.write_bytes(src.read_bytes().replace(b"namespace {", b"namespace  {", 1))
    after = paths(csrc_copy)
    assert after["window_conv.cu"] != before["window_conv.cu"]
    assert {k: v for k, v in after.items() if k != "window_conv.cu"} == {
        k: v for k, v in before.items() if k != "window_conv.cu"}


def test_a_new_header_renames_the_libraries(csrc_copy):
    before = paths(csrc_copy)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert all(paths(csrc_copy)[s] != before[s] for s in kernels.SOURCES)


def test_the_clip_redo_build_names_its_own_library(csrc_copy):
    """rotated_nms.cu built with -DROTATED_NMS_CLIP_REDO (every clipped
    pair through the overflow redo) is a library of its own, renamed by an
    edit of the source like the normal build."""
    src, defines = kernels.CLIP_REDO
    assert kernels.CLIP_REDO in kernels.VARIANTS
    redo = kernels._so_path(src, csrc_copy, defines)
    assert redo != kernels._so_path(src, csrc_copy)
    assert redo.name.startswith("rotated_nms-")
    text = (csrc_copy / src).read_text()
    assert all(f"#ifdef {d}" in text for d in defines)
    (csrc_copy / src).write_text(text + "\n// edited\n")
    assert kernels._so_path(src, csrc_copy, defines) != redo


def test_the_clip_redo_wrappers_take_cuda_tensors_only():
    import torch
    b = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.rotated_nms_clip_redo(b, torch.zeros(4),
                                      torch.ones(4, dtype=torch.bool), 0.2, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.rotated_nms_iou(b, clip_redo=True)
