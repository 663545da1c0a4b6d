"""The port imports neither JAX nor anything of the JAX package."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import graph_hypernetwork_forge_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
ref = "graph_hypernetwork_forge_tpu"
bad = sorted(
    k for k in sys.modules
    if k == "jax" or k.startswith("jax.") or k == ref or k.startswith(ref + ".")
)
native_loaded = port.__name__ + "._ghf_native" in sys.modules
print(len(names), bad, native_loaded)
"""


def test_port_and_all_submodules_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    assert int(out[0]) >= 20, "submodules were not found"
    # Importing builds and loads nothing: the native extension loads at first use.
    assert out[1:] == ["[]", "False"]


def test_training_and_the_new_kernel_module_are_probed():
    # The probe above walks every submodule; these are the ones the later
    # slices added, so a rename cannot drop them from the walk silently.
    import pkgutil

    import graph_hypernetwork_forge_tpu_torch as port

    names = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    for mod in ("training", "training.objectives", "training.train",
                "ops.cuda.edge_transform_bwd", "ops.cuda.segment_outer",
                "native_bridge", "data.sampling", "data.datasets", "data.triples",
                "training.evaluate", "training.checkpoint", "training.minibatch",
                "utils.metrics", "utils.profiling", "parallel", "parallel.mesh",
                "parallel.collectives", "parallel.edge_partition",
                "parallel.relation_sharding", "parallel.sharding",
                "parallel.data_parallel", "parallel.node_partition", "parallel.halo",
                "experiments", "experiments.protocol", "experiments.train_linkpred",
                "experiments.sweep_zeroshot", "experiments.parity_zeroshot"):
        assert f"{port.__name__}.{mod}" in names, mod
