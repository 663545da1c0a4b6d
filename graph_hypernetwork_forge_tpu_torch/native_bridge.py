"""Loader for the native C++ graph builder (``native/ghf_native.cpp``).

The extension implements the host side's hot path in C++: order-preserving
relation dedup, char tokenization, the CSR build over dst (a stable counting
sort), the stable counting sort of edges by relation, and one
neighbor-sampling hop. :func:`get_native` compiles it with ``g++`` on first
use into ``build/ghf_native/`` at the repository root, named by a hash of
the source, and loads it as ``graph_hypernetwork_forge_tpu_torch._ghf_native``
(a name of its own, so it never takes the place of another package's
``_ghf_native`` in ``sys.modules``). Nothing under ``native/`` is written.

Without a compiler or Python's headers, :func:`get_native` returns ``None``
and every caller runs its numpy version, whose results are identical (the
tests hold the two against each other), except that a sampling hop draws
other (equally uniform) samples.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "ghf_native.cpp"
BUILD_DIR = _REPO / "build" / "ghf_native"
MODULE_NAME = "graph_hypernetwork_forge_tpu_torch._ghf_native"

_NATIVE = None
_TRIED = False


def _compile_command(source: Path, out: Path) -> list:
    """The flags of ``native/build.py``."""
    import numpy as np

    return [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
        str(source), "-o", str(out),
    ]


def library_path() -> Path:
    """``BUILD_DIR/_ghf_native_<hash><EXT_SUFFIX>``: the hash covers the
    source's bytes and the Python and numpy it is built against, so an
    edited source, or another interpreter or numpy, is rebuilt."""
    import numpy as np

    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(f"{sys.version}\0{np.__version__}".encode())
    digest = digest.hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_ghf_native_{digest}{suffix}"


def build() -> Path:
    """Compile the extension unless it is built; return its path.

    Processes that build at once take turns through a lock file; each
    compiles to a file of its own and renames it into place.
    """
    lib = library_path()
    if lib.exists():
        return lib
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(_compile_command(SOURCE, tmp), check=True,
                               capture_output=True, text=True, timeout=600)
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
    return lib


def _load(path: Path):
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, str(path), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    sys.modules[MODULE_NAME] = module
    return module


def get_native():
    """The native module, or None if it cannot be built or loaded."""
    global _NATIVE, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _NATIVE = _load(build())
        except (OSError, RuntimeError, ImportError, subprocess.SubprocessError):
            _NATIVE = None
    return _NATIVE


def native_available() -> bool:
    return get_native() is not None
