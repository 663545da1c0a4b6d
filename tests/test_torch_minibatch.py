"""The port's minibatch trainer against the JAX package's: the same sampled
batch from the same generator, and one step from the same parameters
(``convert.params_from_jax``) with the same negatives, on ``dense`` and on
``grouped``, within the f32 gate: atol 3e-5 per leaf (gradients after
dividing by ``max(1, max|ref|)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.datasets import generate_synthetic_kg as jax_kg
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.training.minibatch import (
    MinibatchSpec as JaxSpec,
    MinibatchTrainer as JaxTrainer,
)
from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.data.datasets import generate_synthetic_kg
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.training.minibatch import (
    MinibatchSpec,
    MinibatchTrainer,
)
from graph_hypernetwork_forge_tpu_torch.training.train import adam, create_train_state
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from test_torch_encoding import _assert_same_array, _assert_same_graph
from torch_cases import ATOL, assert_scaled_close

SPEC = dict(batch_size=64, fanouts=(5, 5), node_bucket_multiple=128)
CFG = dict(text_dim=16, node_feat_dim=16, hidden_dim=16, num_layers=2)


def _trainers(backend="auto", seed=0, lr=1e-3):
    kg = generate_synthetic_kg(150, 800, 8, feat_dim=16, seed=seed)
    jcfg = jhg.HyperGNNConfig(**CFG, backend=backend)
    pcfg = phg.HyperGNNConfig(**CFG, backend=backend)
    jt = JaxTrainer(jcfg, optax.adam(lr), kg.edge_index, kg.edge_texts,
                    kg.node_features, JaxSpec(**SPEC))
    pt = MinibatchTrainer(pcfg, adam(lr), kg.edge_index, kg.edge_texts,
                          kg.node_features, MinibatchSpec(**SPEC), device="cpu")
    return jcfg, jt, pt


def _assert_same_batch(got, want):
    for i, name in ((0, "feats"), (2, "pos_src"), (3, "pos_dst"), (4, "pos_mask")):
        _assert_same_array(got[i], want[i], name)
    _assert_same_graph(got[1], want[1])


def test_sample_batch_matches_jax_from_the_same_generator():
    assert generate_synthetic_kg(150, 800, 8, feat_dim=16).edge_texts == \
        jax_kg(150, 800, 8, feat_dim=16).edge_texts
    _, jt, pt = _trainers()
    got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        got, want = pt.sample_batch(got_rng), jt.sample_batch(want_rng)
        _assert_same_batch(got, want)
        assert got[0].shape[0] % SPEC["node_bucket_multiple"] == 0
        assert got[2].shape == (SPEC["batch_size"],)


@pytest.mark.parametrize("backend", ["dense", "grouped"])
def test_one_step_matches_jax_with_the_same_negatives(backend):
    jcfg, jt, pt = _trainers(backend)
    np_params = jax.tree_util.tree_map(
        np.asarray, jhg.init_hypergnn(jcfg, jax.random.PRNGKey(0)))
    # Generated weights at scale 1 instead of the 0.01 init, so message
    # passing carries real gradient to every generator leaf.
    for g in np_params["weight_generators"]:
        g["log_scales"] = {k: np.zeros((1,), np.float32) for k in g["log_scales"]}
    batch = pt.sample_batch(np.random.default_rng(5))
    _assert_same_batch(batch, jt.sample_batch(np.random.default_rng(5)))
    feats, graph, pos_src, pos_dst, pos_mask = batch

    key = jax.random.PRNGKey(9)
    # The negatives JAX's step draws from its key (minibatch.py:88-90).
    neg = np.asarray(jax.random.randint(key, pos_src.shape, 0, feats.shape[0],
                                        dtype=jnp.int32))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jopt = jt.optimizer.init(jp)
    jp, _, jloss = jt._step_fn(jp, jopt, jnp.asarray(feats),
                               *(jnp.asarray(a) for a in graph.arrays),
                               jnp.asarray(pos_src), jnp.asarray(pos_dst),
                               jnp.asarray(pos_mask), key)
    # The gradient JAX's step took, for the per-leaf gradient gate.
    jgrads = jax.grad(lambda p: _jax_loss(jcfg, p, feats, graph, pos_src, pos_dst,
                                          pos_mask, neg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))

    state = create_train_state(params_from_jax(np_params), pt.optimizer)
    params, _, loss = pt.device_step(state.params, state.opt_state,
                                     pt.to_device(batch), neg_dst=torch.from_numpy(neg.copy()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=ATOL)
    want_grads = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    want_params = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for path, leaf in named_leaves(params):
        assert_scaled_close(leaf.grad.numpy(), want_grads[path], err_msg=path)
        np.testing.assert_allclose(leaf.detach().numpy(), want_params[path],
                                   rtol=0, atol=ATOL, err_msg=path)


def _jax_loss(cfg, params, feats, graph, pos_src, pos_dst, pos_mask, neg):
    """The loss of JAX's minibatch step (minibatch.py:71-78)."""
    embs = jhg.apply_hypergnn(cfg, params, jnp.asarray(feats),
                              *(jnp.asarray(a) for a in graph.arrays))
    pos = jhg.score_triple(embs[pos_src], embs[pos_dst])
    neg_s = jhg.score_triple(embs[pos_src], embs[neg])
    per = jnp.clip(1.0 - pos + neg_s, a_min=0.0)
    return jnp.sum(per * pos_mask) / jnp.maximum(jnp.sum(pos_mask), 1.0)


def test_loss_decreases_over_steps():
    _, _, pt = _trainers(lr=5e-3)
    init = phg.init_hypergnn(pt.config, torch.Generator().manual_seed(0))
    state = create_train_state(init, pt.optimizer)
    params, opt_state = state.params, state.opt_state
    rng_np, gen = np.random.default_rng(0), torch.Generator().manual_seed(1)
    losses = []
    for _ in range(12):
        params, opt_state, loss = pt.step(params, opt_state, rng_np, gen)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_negatives_are_drawn_from_the_generator():
    _, _, pt = _trainers()
    init = phg.init_hypergnn(pt.config, torch.Generator().manual_seed(0))
    tensors = pt.to_device(pt.sample_batch(np.random.default_rng(1)))
    losses = []
    for _ in range(2):
        state = create_train_state(init, pt.optimizer)
        losses.append(pt.device_step(state.params, state.opt_state, tensors,
                                     torch.Generator().manual_seed(4))[2])
    assert torch.equal(losses[0], losses[1])
    with pytest.raises(ValueError):
        state = create_train_state(init, pt.optimizer)
        pt.device_step(state.params, state.opt_state, tensors)
