"""The port's GPipe pipeline (``parallel/pipeline.py``) on k gloo ranks, one
stage a rank, against the JAX package on k virtual CPU devices: the twin
of ``tests/test_pipeline.py``.

- ``pipelined_forward`` at S = k stages (4 layers, 5 microbatches) within
  1e-5 of JAX's ``pipelined_forward`` (test_pipeline.py:72);
- the gradients of ``Σ out²`` w.r.t. every parameter against ``jax.grad``
  of the sequential sum over microbatches, 3e-5 after dividing by
  max(1, max|JAX|);
- one ``make_pipelined_train_step`` against JAX's, on JAX's negatives: the
  loss within 1e-5 (:163), the parameters after Adam at the gradient gate;
- 8 layers, remat, and a dropout config in eval mode against JAX's
  ``apply_hypergnn`` per microbatch within 2e-5 (:227, :245, :263);
- dropout masks that do not depend on S (the same output at S = k and S =
  1), that remat recomputes (the same gradients with and without it), and
  training losses that depend on the generator;
- ``stack_layer_params`` equal to JAX's, and the refusal of a layer count
  the stages do not divide.

One spawn of k ranks per world size (``torch_parallel_ranks_cd.pipeline``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu.models.hypergnn import (
    HyperGNNConfig,
    apply_hypergnn,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu.parallel.pipeline import (
    make_pipelined_train_step,
    pipelined_forward,
    stack_layer_params,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import assert_scaled_close
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
N_NODES, N_MICRO, HIDDEN, LR = 12, 5, 16, 1e-2
CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=HIDDEN, num_layers=4)
# Name: (config, parameter seed) of test_pipeline.py's cases.
CASES = {
    "p4": (CONFIG, 7),
    "p8": (dataclasses.replace(CONFIG, num_layers=8), 3),
    "remat": (dataclasses.replace(CONFIG, remat=True), 4),
    "eval_dropout": (dataclasses.replace(CONFIG, dropout=0.5), 2),
}


@functools.lru_cache(maxsize=1)
def _microbatches():
    """test_pipeline.py's microbatches: identical static shapes, every
    relation in each."""
    rng = np.random.default_rng(0)
    texts = ["works with", "located in", "reports to"]
    feats, graphs = [], []
    for _ in range(N_MICRO):
        edge_index = np.stack(
            [rng.integers(0, N_NODES, size=24), rng.integers(0, N_NODES, size=24)]
        ).astype(np.int64)
        edge_texts = [texts[i] for i in rng.integers(0, len(texts), size=24)]
        edge_texts[:3] = texts
        feats.append(rng.standard_normal((N_NODES, 8)).astype(np.float32))
        graphs.append(encode_graph(edge_index, edge_texts, N_NODES))
    return [np.stack(feats)] + [np.stack([g.arrays[i] for g in graphs]) for i in range(6)]


@functools.lru_cache(maxsize=None)
def _params(name):
    config, seed = CASES[name]
    return jax.tree_util.tree_map(np.asarray, init_hypergnn(config, jax.random.PRNGKey(seed)))


@functools.partial(jax.jit, static_argnums=0)
def _sequential(config, params, batch):
    return jax.vmap(lambda f, *a: apply_hypergnn(config, params, f, *a))(*batch)


@functools.lru_cache(maxsize=1)
def _references():
    """The world-independent references: JAX's apply_hypergnn per
    microbatch for the 8-layer, remat and dropout cases, and jax.grad of
    the sequential Σ out² at 4 layers."""
    batch = [jnp.asarray(a) for a in _microbatches()]
    eval_config = dataclasses.replace(CONFIG, num_layers=8)
    refs = {name: _sequential(eval_config if name == "p8" else CONFIG, _params(name), batch)
            for name in ("p8", "remat", "eval_dropout")}
    refs["grads"] = jax.jit(jax.grad(
        lambda p: jnp.sum(_sequential(CONFIG, p, batch) ** 2)))(_params("p4"))
    return refs


def _jax(k):
    """JAX's pipelined forward and train step on k stages, and the step's
    negatives."""
    batch = [jnp.asarray(a) for a in _microbatches()]
    mesh = make_mesh((k,), ("pipe",), devices=jax.devices()[:k])
    params = jax.tree_util.tree_map(jnp.asarray, _params("p4"))
    out = jax.jit(lambda p: pipelined_forward(mesh, CONFIG, p, *batch))(params)
    optimizer = optax.adam(LR)
    step = make_pipelined_train_step(mesh, CONFIG, optimizer)
    rng = jax.random.PRNGKey(3)
    new_params, _, loss = step(params, optimizer.init(params), *batch, rng)
    neg = jax.random.randint(jax.random.split(rng)[0], batch[1].shape, 0, N_NODES,
                             dtype=batch[1].dtype)
    return dict(fwd4=out, new_params=new_params, loss=loss, neg=np.asarray(neg))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    want = _jax(k)
    inputs = {f"mb/{i}": a for i, a in enumerate(_microbatches())}
    inputs["neg"] = want["neg"]
    for name, (config, _) in CASES.items():
        inputs[f"{name}/dims"] = np.array([config.text_dim, config.node_feat_dim,
                                           config.hidden_dim, config.num_layers])
        inputs[f"{name}/dropout"] = np.float32(config.dropout)
        inputs[f"{name}/remat"] = np.int64(config.remat)
        inputs.update({f"{name}/params/{p}": a for p, a in named_leaves(_params(name))})
    outs = spawn("torch_parallel_ranks_cd:pipeline", k,
                 tmp_path_factory.mktemp(f"pipe_k{k}"), inputs)
    return k, dict(want, **_references()), outs


def test_pipelined_forward_matches_jax(ranks):
    _, want, outs = ranks
    for o in outs:
        assert o["fwd4"].shape == (N_MICRO, N_NODES, HIDDEN)
        np.testing.assert_allclose(o["fwd4"], np.asarray(want["fwd4"]), atol=1e-5, rtol=1e-5)


def test_gradients_match_jax_grad_of_the_sequential_sum(ranks):
    _, want, outs = ranks
    for o in outs:
        for path, g in named_leaves(jax.tree_util.tree_map(np.asarray, want["grads"])):
            assert_scaled_close(o[f"grad/{path}"], g, err_msg=path)


def test_pipelined_train_step_matches_jax(ranks):
    _, want, outs = ranks
    for o in outs:
        np.testing.assert_allclose(float(o["step/loss"]), float(want["loss"]), atol=1e-5)
        for path, p in named_leaves(jax.tree_util.tree_map(np.asarray, want["new_params"])):
            assert_scaled_close(o[f"step/param/{path}"], p, err_msg=path)
    # The parameters moved.
    assert any(not np.allclose(outs[0][f"step/param/{p}"], a)
               for p, a in named_leaves(_params("p4")))


@pytest.mark.parametrize("name", ["p8", "remat", "eval_dropout"])
def test_depth_remat_and_eval_dropout_match_single_device(ranks, name):
    _, want, outs = ranks
    for o in outs:
        np.testing.assert_allclose(o[name], np.asarray(want[name]), atol=2e-5)


def test_dropout_masks_do_not_depend_on_the_stages(ranks):
    _, want, outs = ranks
    for o in outs:
        np.testing.assert_array_equal(o["dropout/stages"], outs[0]["dropout/stages"])
        np.testing.assert_allclose(o["dropout/stages"], o["dropout/one_stage"],
                                   atol=1e-6, rtol=0)
        # Dropout is on: the output is not the eval output.
        assert not np.allclose(o["dropout/stages"], np.asarray(want["eval_dropout"]),
                               atol=1e-3)
        assert np.isfinite(o["dropout/loss10"]) and np.isfinite(o["dropout/loss11"])
        assert float(o["dropout/loss10"]) != float(o["dropout/loss11"])


def test_remat_recomputes_the_same_dropout_masks(ranks):
    _, _, outs = ranks
    for o in outs:
        for path, _ in named_leaves(_params("eval_dropout")):
            np.testing.assert_allclose(o[f"remat_dropout/True/{path}"],
                                       o[f"remat_dropout/False/{path}"], atol=1e-6,
                                       rtol=0, err_msg=path)


def test_stack_layer_params_matches_jax(ranks):
    _, _, outs = ranks
    gens, norms = stack_layer_params(_params("p4"))
    for path, a in named_leaves({"gens": gens, "norms": norms}):
        assert a.shape[0] == CONFIG.num_layers
        for o in outs:
            np.testing.assert_array_equal(o[f"stacked/{path}"], np.asarray(a), err_msg=path)


def test_indivisible_layers_raise(ranks):
    _, _, outs = ranks
    for o in outs:
        assert "divisible" in o["err/indivisible"].item()
