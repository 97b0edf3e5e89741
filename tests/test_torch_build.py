"""The kernel build cache (``pytorchrec_tpu_torch/ops/kernels/build.py``):
a library's name hashes its source, every shared ``csrc/*.cuh`` header and
the nvcc flags, so an edit to any of them builds anew instead of loading a
stale library. Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from pytorchrec_tpu_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc`` that ``build`` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["cross", "retrieval_topk", "scatter"])
def test_editing_a_header_changes_every_library_path(name, tmp_path, monkeypatch):
    package_path = build.library_path(name)
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    assert build.library_path(name) == package_path  # a copy hashes as the package
    header = copy / "shared.cuh"
    header.write_text("#pragma once\nconstexpr int kWidth = 1;\n")
    before = build.library_path(name)
    assert before == build.library_path(name)  # deterministic
    header.write_text("#pragma once\nconstexpr int kWidth = 2;\n")
    assert build.library_path(name) != before


def test_adding_or_removing_a_header_changes_the_path(csrc):
    before = build.library_path("cross")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = build.library_path("cross")
    assert with_header != before
    (csrc / "extra.cuh").unlink()
    assert build.library_path("cross") == before


def test_only_cuh_files_are_headers(csrc):
    before = build.library_path("cross")
    (csrc / "notes.txt").write_text("not a header\n")
    assert build.library_path("cross") == before


def test_editing_a_source_changes_only_its_own_path(csrc):
    cross, scatter = build.library_path("cross"), build.library_path("scatter")
    source = csrc / "cross.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert build.library_path("cross") != cross
    assert build.library_path("scatter") == scatter


def test_the_flags_enter_the_hash(csrc, monkeypatch):
    before = build.library_path("cross")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("cross") != before
