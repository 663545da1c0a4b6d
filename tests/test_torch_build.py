"""The kernel builder names each library by its source and the shared headers.

No nvcc and no card: these check the names and the command line only, on a
copy of ``csrc/``.
"""

import shutil

import pytest

from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build


@pytest.fixture
def sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(build.SOURCE_DIR, src)
    monkeypatch.setattr(build, "SOURCE_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("name", kernels.KERNEL_SOURCES)
def test_library_path_changes_when_a_header_changes(sources, name):
    before = build._library_path(name)
    assert before == build._library_path(name), "the name must be stable"
    header = sources / "tf32x3.cuh"
    header.write_bytes(header.read_bytes() + b"\n// one more line\n")
    after = build._library_path(name)
    assert after != before
    assert after.parent == build.BUILD_DIR and after.name.startswith(f"lib{name}_")


def test_a_new_header_renames_every_library_and_a_source_only_its_own(sources):
    names = kernels.KERNEL_SOURCES
    before = {n: build._library_path(n) for n in names}
    (sources / "extra.cuh").write_text("#pragma once\n")
    with_header = {n: build._library_path(n) for n in names}
    assert all(with_header[n] != before[n] for n in names)
    (sources / "segment_sum.cu").write_text("// edited\n", encoding="utf-8")
    edited = {n: build._library_path(n) for n in names}
    assert [n for n in names if edited[n] != with_header[n]] == ["segment_sum"]


def test_nvcc_gets_the_source_directory_for_its_includes(sources, monkeypatch):
    seen = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            seen.append(cmd)

    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakePopen)
    _, tmp, lib = build._start("edge_transform_bwd")
    [cmd] = seen
    assert cmd[0] == "nvcc" and cmd[-1] == str(sources / "edge_transform_bwd.cu")
    assert cmd[cmd.index("-I") + 1] == str(sources)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert lib == build._library_path("edge_transform_bwd") and tmp.parent == lib.parent
