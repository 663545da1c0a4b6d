"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under ``graph_hypernetwork_forge_tpu_torch/csrc/`` compiles on
first use into its own shared library with a plain C interface, for
``sm_90a`` (Hopper). The library lands in ``build/ghf_torch_kernels/`` at
the repository root, named by a hash of its source and of every shared
header (``csrc/*.cuh``), so an edited source or header is rebuilt and never
mixed up with an older build. Nothing is built when a
module is imported: the wrappers call :func:`load` when they first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "ghf_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on first use and "
        "need the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)"
    )


def _library_path(name: str) -> Path:
    """``BUILD_DIR/lib<name>_<hash>.so``: the hash covers ``<name>.cu`` and
    the bytes of every header in ``SOURCE_DIR``, in name order."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    lib = _library_path(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        nvcc_path(), *NVCC_FLAGS, "-I", str(SOURCE_DIR),
        "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu"),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that has no current library, all at once.

    Returns ``{name: {"seconds": wall time, "log": nvcc output}}`` for the
    sources it compiled (``-Xptxas=-v`` puts registers and spills in the
    log). Raises ``RuntimeError`` with nvcc's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {
        name: _start(name)
        for name in names
        if not _library_path(name).exists()
    }
    results: Dict[str, dict] = {}
    failures = []
    for name, (proc, tmp, lib) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
        results[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
