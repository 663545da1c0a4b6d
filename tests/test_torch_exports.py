"""Every public name of the JAX package's subpackages is public in the
port's counterpart, and the port's ``models.hypergnn`` has the module-level
``score_triple``.

Left out, for its reason: ``utils.resolve_precision`` maps a string to
``jax.lax.Precision``, which has no PyTorch meaning (the port checks the
string with ``utils.initializers.check_precision``). ``parallel`` exports
all of JAX's names.

Module by module (``ast``): every public top-level name that a JAX module
defines (a function, a class or an assignment) has a counterpart in the
port's module of the same path, with these exceptions and their reasons:

- ``resolve_precision`` (``utils/initializers.py``), as above;
- ``shard_map`` (``parallel/edge_partition.py``, ``pipeline.py``): an alias
  of ``jax.shard_map``, whose bodies the port's functions are;
- the TPU kernels' modules ``ops/pallas/*.py``: their counterparts are the
  CUDA kernels' wrappers under ``ops/cuda/`` (``KERNEL_COUNTERPARTS``;
  PERF.md's kernel table); their tile constants ``TILE_N``, ``CHUNK`` and
  ``DEFAULT_TILE_E`` size Mosaic blocks and have none.
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

NOT_PORTED = {"utils": {"resolve_precision"}}


@pytest.mark.parametrize("sub", ["models", "ops", "utils", "data", "training", "parallel"])
def test_subpackage_exports_the_jax_names(sub):
    jax_all = importlib.import_module(f"graph_hypernetwork_forge_tpu.{sub}").__all__
    port = importlib.import_module(f"graph_hypernetwork_forge_tpu_torch.{sub}")
    want = set(jax_all) - NOT_PORTED.get(sub, set())
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in want:
        assert getattr(port, name) is not None, name


def test_score_triple_at_module_level_matches_jax():
    from graph_hypernetwork_forge_tpu.models.hypergnn import score_triple as jax_score
    from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNN, score_triple

    rng = np.random.default_rng(0)
    for shape in ((8,), (5, 8)):
        a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        want = np.asarray(jax_score(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(score_triple(torch.from_numpy(a), torch.from_numpy(b)),
                                   want, rtol=1e-6, atol=1e-6)
        model = HyperGNN(16, 8, 8, device="cpu")
        np.testing.assert_array_equal(model.score_triple(a, b), score_triple(a, b))


JAX_ROOT = Path(__file__).resolve().parents[1] / "graph_hypernetwork_forge_tpu"
NO_COUNTERPART = {
    "utils/initializers.py": {"resolve_precision"},
    "parallel/edge_partition.py": {"shard_map"},
    "parallel/pipeline.py": {"shard_map"},
    "ops/pallas/segment_sum.py": {"TILE_N", "CHUNK"},
    "ops/pallas/edge_transform.py": {"DEFAULT_TILE_E"},
}
# The TPU kernels' functions: the port's module and name of each
# counterpart (kernel 4 is kernel 1 at d=64; the combined contributions are
# the ``cuda`` backend of message passing).
KERNEL_COUNTERPARTS = {
    "ops/pallas/segment_sum.py": {
        "sorted_segment_sum_pallas": ("ops.cuda.segment_sum", "csr_segment_sum"),
        "sorted_segment_sum_packed64": ("ops.cuda.segment_sum", "csr_segment_sum"),
        "dual_sorted_segment_sum_pallas": ("ops.cuda.segment_sum", "dual_sorted_segment_sum"),
    },
    "ops/pallas/edge_transform.py": {
        "GROUP_PAD": ("data.encoding", "GROUP_PAD"),
        "edge_transform_sorted_combined": ("ops.cuda.edge_transform",
                                           "edge_transform_sorted_combined"),
        "edge_transform_sorted": ("ops.cuda.edge_transform", "edge_transform_sorted"),
        "edge_contributions_pallas_sorted": ("ops.cuda.edge_transform",
                                             "edge_contributions_cuda_sorted"),
        "edge_contributions_pallas_combined": ("ops.message_passing",
                                               "relational_message_passing"),
    },
}
JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def _defined_public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(rel):
    want = _defined_public_names(JAX_ROOT / rel) - NO_COUNTERPART.get(rel, set())
    if rel.startswith("ops/pallas/"):
        counterparts = KERNEL_COUNTERPARTS.get(rel, {})
        assert want == set(counterparts), sorted(want ^ set(counterparts))
        for module, name in counterparts.values():
            port = importlib.import_module(f"graph_hypernetwork_forge_tpu_torch.{module}")
            assert getattr(port, name, None) is not None, (module, name)
        return
    module = rel[: -len(".py")].replace("/", ".").removesuffix(".__init__")
    port = importlib.import_module(f"graph_hypernetwork_forge_tpu_torch.{module}")
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, missing
