"""The port's native bridge against the JAX package's, and the port's
encoder with and without the extension against the JAX encoder.

The port builds ``native/ghf_native.cpp`` into a build directory of its
own and loads it under its own module name; every function must return
what the JAX bridge's module returns, and every array of ``encode_graph``
must be identical natively, with the bridge patched to None, and in JAX.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from graph_hypernetwork_forge_tpu import native_bridge as jax_bridge
from graph_hypernetwork_forge_tpu.data import encoding as jenc
from graph_hypernetwork_forge_tpu_torch import native_bridge
from graph_hypernetwork_forge_tpu_torch.data import encoding as penc
from test_torch_encoding import _assert_same_array, _assert_same_graph

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def modules():
    port, ref = native_bridge.get_native(), jax_bridge.get_native()
    if port is None or ref is None:
        pytest.skip("no C++ toolchain to build the native extension")
    return port, ref


def _dir_state(path):
    return {
        p.name: (p.stat().st_size, p.stat().st_mtime_ns,
                 hashlib.sha256(p.read_bytes()).hexdigest())
        for p in sorted(path.iterdir()) if p.is_file()
    }


_BUILD_PROBE = """
import json, sys
from graph_hypernetwork_forge_tpu_torch import native_bridge as b
m = b.get_native()
print(json.dumps({"name": m.__name__, "file": m.__file__,
                  "plain_name_taken": "_ghf_native" in sys.modules}))
"""


def test_bridge_builds_into_its_own_directory_and_writes_nothing_under_native(
        tmp_path, modules):
    # A copy of the port and of native/, so that no other process's use of
    # the JAX bridge (which may rebuild native/'s library) can interfere.
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(REPO / "graph_hypernetwork_forge_tpu_torch",
                    tmp_path / "graph_hypernetwork_forge_tpu_torch", ignore=ignore)
    shutil.copytree(REPO / "native", tmp_path / "native", ignore=ignore)
    before = _dir_state(tmp_path / "native")
    out = subprocess.run(
        [sys.executable, "-c", _BUILD_PROBE], cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(tmp_path)},
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["name"] == "graph_hypernetwork_forge_tpu_torch._ghf_native"
    assert Path(got["file"]).parent == tmp_path / "build" / "ghf_native"
    assert not got["plain_name_taken"]
    assert _dir_state(tmp_path / "native") == before


def test_both_bridges_load_side_by_side(modules):
    port, ref = modules
    assert port is not ref
    assert sys.modules["_ghf_native"] is ref
    assert sys.modules[native_bridge.MODULE_NAME] is port
    assert native_bridge.native_available()


def _texts(seed, e=500):
    rng = np.random.default_rng(seed)
    vocab = [f"relation kind {i}" for i in range(11)] + ["", "naïve ünïcode ☃"]
    return [vocab[i] for i in rng.integers(0, len(vocab), e)]


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        _assert_same_array(a, b, "array")
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["dedup_and_ids", "tokenize_batch", "build_csr",
                                "sort_by_relation", "sample_hop"])
def test_native_functions_match_the_jax_bridge(modules, fn, seed):
    rng = np.random.default_rng(seed)
    n, e = 200, 3000
    dst = rng.integers(0, n, e).astype(np.int64)
    args = {
        "dedup_and_ids": lambda: (_texts(seed),),
        "tokenize_batch": lambda: (sorted(set(_texts(seed))), 8),
        "build_csr": lambda: (dst, n),
        "sort_by_relation": lambda: (rng.integers(0, 13, e).astype(np.int32), 16),
        "sample_hop": lambda: (*modules[1].build_csr(dst, n),
                               np.unique(rng.integers(0, n, 40)), 5, 1234 + seed),
    }[fn]()
    port, ref = modules
    _same(getattr(port, fn)(*args), getattr(ref, fn)(*args))


def _random_graph(seed, n=70, e=900):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return ei, _texts(seed, e), n


_LAYOUTS = [
    dict(),
    dict(pad=False),
    dict(sort_by_relation=True),
    dict(sort_by_relation=True, pad=False),
    dict(with_sort_plan=True),
    dict(sort_by_relation=True, with_sort_plan=True),
    dict(sort_by_relation=True, group_pad=256),
    dict(sort_by_relation=True, with_sort_plan=True, group_pad=256),
    dict(sort_by_relation=True, with_sort_plan=True, group_pad=64, pad=False),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda d: str(sorted(d.items())))
def test_encode_graph_is_identical_natively_without_native_and_in_jax(
        modules, monkeypatch, layout, seed):
    ei, etexts, n = _random_graph(seed)
    native = penc.encode_graph(ei, etexts, n, **layout)
    want = jenc.encode_graph(ei, etexts, n, **layout)
    with monkeypatch.context() as m:
        m.setattr(native_bridge, "get_native", lambda: None)
        plain = penc.encode_graph(ei, etexts, n, **layout)
    for got in (native, plain):
        _assert_same_graph(got, want)
    if layout.get("with_sort_plan"):
        for name in ("tile_splits", "run_splits"):
            _assert_same_array(getattr(native.sort_plan, name),
                               getattr(plain.sort_plan, name), name)


def test_encode_graph_with_texts_in_an_array_matches_jax(modules):
    ei, etexts, n = _random_graph(2)
    layout = dict(sort_by_relation=True, with_sort_plan=True, group_pad=256)
    got = penc.encode_graph(ei, np.asarray(etexts), n, **layout)
    want = jenc.encode_graph(ei, np.asarray(etexts), n, **layout)
    _assert_same_graph(got, want)
