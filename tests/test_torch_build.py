"""The kernel builder names each library by its source and the shared headers.

No nvcc and no card: these check the names and the command line only, on a
copy of ``csrc/``, and that every C entry a wrapper binds is one its source
defines.
"""

import re
import shutil
from pathlib import Path

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


@pytest.mark.parametrize("header_name", ["tf32x3.cuh", "bf16_mma.cuh"])
@pytest.mark.parametrize("name", kernels.KERNEL_SOURCES)
def test_library_path_changes_when_a_header_changes(sources, name, header_name):
    before = build._library_path(name)
    assert before == build._library_path(name), "the name must be stable"
    header = sources / header_name
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


def _entries(cu: Path) -> set:
    return set(re.findall(r'extern "C" int (ghf_\w+)\(', cu.read_text()))


def test_every_entry_a_wrapper_binds_is_defined_in_its_source():
    # Each wrapper module loads one source (load("<name>")); the names it
    # reads off the library (lib.ghf_..., or the entry tables of kernels 1
    # and 7) must be that source's extern "C" functions, and each of those
    # is bound. The tune script binds a subset of the same names.
    wrappers = Path(build.__file__).parent
    defined = set()
    for name in kernels.KERNEL_SOURCES:
        entries = _entries(build.SOURCE_DIR / f"{name}.cu")
        defined |= entries
        bound = set()
        for py in wrappers.glob("*.py"):
            text = py.read_text()
            if f'load("{name}")' in text:
                bound |= set(re.findall(r"(?:lib\.|\")(ghf_\w+)", text))
        assert bound == entries, (name, sorted(bound ^ entries))
    assert "ghf_edge_transform_two_bf16" in defined and "ghf_segment_outer_bf16" in defined
    assert "ghf_dual_csr_segment_sum_bf16" in defined
    assert {"ghf_csr_segment_sum_fast", "ghf_dual_csr_segment_sum_fast"} <= defined
    tune = (Path(build.__file__).parents[3] / "scripts" / "tune_edge_kernels.py").read_text()
    listed = re.search(r"C_FUNCTIONS = \(([^)]*)\)", tune).group(1)
    assert set(re.findall(r"ghf_\w+", listed)) <= defined
