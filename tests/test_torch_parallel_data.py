"""The port's data-parallel step on k gloo ranks against the JAX package's
on k virtual CPU devices: the same batch of B = 4 subgraphs, the same
parameters and the JAX step's negatives; loss within 1e-5 and every
parameter after Adam within 3e-5 (tests/test_data_parallel.py:57, :64).
With dropout on, each rank draws its own masks, and the summed gradients
must still leave every rank with the same parameters.

One spawn of k ranks per world size (``torch_parallel_ranks.data_parallel``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu.parallel.data_parallel import make_data_parallel_step
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16, num_layers=2)
N_NODES, BATCH, LR = 12, 4, 1e-2


@functools.lru_cache(maxsize=1)
def _cases():
    """tests/test_pipeline.py's microbatches: identical static shapes."""
    rng = np.random.default_rng(3)
    texts = ["works with", "located in", "reports to"]
    feats, graphs = [], []
    for _ in range(BATCH):
        edge_index = np.stack(
            [rng.integers(0, N_NODES, size=24), rng.integers(0, N_NODES, size=24)]
        ).astype(np.int64)
        edge_texts = [texts[i] for i in rng.integers(0, len(texts), size=24)]
        edge_texts[:3] = texts
        feats.append(rng.standard_normal((N_NODES, 8)).astype(np.float32))
        graphs.append(encode_graph(edge_index, edge_texts, N_NODES))
    batch = [np.stack(feats)] + [np.stack([g.arrays[i] for g in graphs]) for i in range(6)]
    params = jax.tree_util.tree_map(np.asarray, init_hypergnn(CONFIG, jax.random.PRNGKey(5)))
    return batch, params


def _jax_step(k):
    """The JAX DP step and the negatives it draws (its rng split as
    tests/test_data_parallel.py reads it)."""
    batch, params = _cases()
    mesh = make_mesh((k,), ("data",), devices=jax.devices()[:k])
    optimizer = optax.adam(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    step = make_data_parallel_step(mesh, CONFIG, optimizer)
    rng = jax.random.PRNGKey(9)
    new, _, loss = step(jparams, optimizer.init(jparams), *map(jnp.asarray, batch), rng)
    neg = jax.random.randint(jax.random.split(rng)[0], batch[1].shape, 0, N_NODES,
                             dtype=batch[1].dtype)
    return new, loss, np.asarray(neg)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    batch, params = _cases()
    new, loss, neg = _jax_step(k)
    inputs = {f"batch/{i}": a for i, a in enumerate(batch)}
    inputs.update({f"params/{p}": v for p, v in named_leaves(params)})
    inputs["neg"] = neg
    return new, loss, spawn("data_parallel", k, tmp_path_factory.mktemp(f"dp_k{k}"), inputs)


def test_dp_step_matches_jax(ranks):
    new, loss, outs = ranks
    for o in outs:
        np.testing.assert_allclose(float(o["parity/loss"]), float(loss), atol=1e-5)
        for path, want in named_leaves(new):
            np.testing.assert_allclose(o[f"parity/param/{path}"], np.asarray(want),
                                       atol=3e-5, err_msg=path)


def test_dp_step_with_dropout_keeps_ranks_equal(ranks):
    _, _, outs = ranks
    paths = [k for k in outs[0] if k.startswith("dropout/param/")]
    assert len(paths) == len(list(named_leaves(_cases()[1])))
    assert np.isfinite(outs[0]["dropout/loss"])
    for o in outs[1:]:
        assert float(o["dropout/loss"]) == float(outs[0]["dropout/loss"])
        for p in paths:
            np.testing.assert_array_equal(o[p], outs[0][p], err_msg=p)
    # Dropout moved the step: the parameters differ from the parity run's.
    assert any(not np.array_equal(outs[0][p], outs[0][p.replace("dropout", "parity")])
               for p in paths)
