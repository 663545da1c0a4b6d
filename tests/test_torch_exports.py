"""Every public name of the JAX package's subpackages is public in the
port's counterpart, and the port's ``models.hypergnn`` has the module-level
``score_triple``.

Left out, for its reason: ``utils.resolve_precision`` maps a string to
``jax.lax.Precision``, which has no PyTorch meaning (the port checks the
string with ``utils.initializers.check_precision``). ``parallel`` exports
all of JAX's names.
"""

import importlib

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
