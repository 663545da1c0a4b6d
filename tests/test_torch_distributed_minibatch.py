"""The port's distributed minibatch trainer against the JAX package's: the
twins of ``tests/test_minibatch.py::TestDistributedMinibatchTrainer``, at 2
and at 4 gloo ranks against JAX on as many virtual CPU devices.

- ``sample_batch_sharded`` from the same ``np.random.Generator`` gives
  JAX's arrays exactly on every rank (feats, the edge blocks, the relation
  texts, the positives and ``rel_group_sizes``);
- one ``make_composed_minibatch_step`` from JAX's initial weights (the
  generators at scale one) and with JAX's negatives, in ``dense`` and in
  ``grouped``: the loss within 1e-5 of JAX's step, the gradients at 3e-5
  after dividing by max(1, max|JAX|), and the parameters after Adam within
  3e-5 (tests/test_minibatch.py:106-112) wherever |g| >= 1e-6: below it
  Adam's first step, lr·g/(|g| + eps), follows the rounding of g (one
  element of 16,384, |g| = 3.5e-8, moves 3.4e-5 from JAX's), and is held
  within 2·lr (``torch_composed_cases.assert_adam_step_close``);
- the trainer's ``device_step`` on the same batch against the port's
  single-card ``MinibatchTrainer.device_step``, with the negatives handed
  in and drawn from the same generator state;
- ten steps lower the loss with one bucket (``len(_dist_steps) == 1``);
- the refusals: a batch size or a node bucket the axis does not divide,
  ``grouped`` without group sizes, ``contrib="cuda"``, a step with neither
  a generator nor negatives.

One spawn of k ranks per world size (``torch_parallel_ranks_mb``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graph_hypernetwork_forge_tpu.data.datasets import generate_synthetic_kg
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu.training.minibatch import (
    DistributedMinibatchTrainer,
    MinibatchSpec,
    make_composed_minibatch_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import ATOL
from torch_composed_cases import assert_adam_step_close, first_adam_grads
from torch_parallel_ranks import spawn
from torch_parallel_ranks_mb import BATCH_FIELDS, SEED_BATCH

WORLDS = (2, 4)
LR = 5e-3
CFG = dict(text_dim=16, node_feat_dim=16, hidden_dim=16, num_layers=2)
SPEC = dict(batch_size=64, fanouts=(5, 5), node_bucket_multiple=128)
CONTRIBS = ("dense", "grouped")


def _scale_one(params):
    """Generated weights at scale one (log_scales 0) instead of the 0.01
    init, so message passing carries real gradient to every leaf."""
    for g in params["weight_generators"]:
        g["log_scales"] = {n: np.zeros((1,), np.float32) for n in g["log_scales"]}
    return params


def _case_inputs(seed, params) -> dict:
    kg = generate_synthetic_kg(150, 800, 8, feat_dim=16, seed=seed)
    out = dict(ei=kg.edge_index, texts=np.array(kg.edge_texts), feats=kg.node_features,
               dims=np.array([CFG[k] for k in ("text_dim", "node_feat_dim", "hidden_dim",
                                               "num_layers")]),
               spec=np.array([SPEC["batch_size"], *SPEC["fanouts"],
                              SPEC["node_bucket_multiple"]]), lr=np.float32(LR))
    out.update({f"params/{p}": a for p, a in named_leaves(params)})
    return out, kg


@functools.lru_cache(maxsize=None)
def _jax(k):
    """JAX's sharded batch and one step in each contribution on k devices,
    with the negatives the step drew."""
    config = HyperGNNConfig(**CFG)
    params = _scale_one(jax.tree_util.tree_map(
        np.asarray, init_hypergnn(config, jax.random.PRNGKey(0))))
    inputs, kg = _case_inputs(0, params)
    mesh = make_mesh((k,), ("edge",), devices=jax.devices()[:k])
    optimizer = optax.adam(LR)
    trainer = DistributedMinibatchTrainer(mesh, config, optimizer, kg.edge_index,
                                          kg.edge_texts, kg.node_features,
                                          MinibatchSpec(**SPEC))
    batch = trainer.sample_batch_sharded(np.random.default_rng(SEED_BATCH))
    rng = jax.random.PRNGKey(9)
    pos_src = batch[8]
    inputs["neg"] = np.asarray(jax.random.randint(rng, pos_src.shape, 0, batch[1].shape[0],
                                                  dtype=pos_src.dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    steps = {}
    for contrib in CONTRIBS:
        step = make_composed_minibatch_step(mesh, config, optimizer,
                                            batch[0].nodes_per_shard, contrib=contrib)
        new, opt_state, loss = step(jparams, optimizer.init(jparams), *batch[1:11], rng,
                                    rel_group_sizes=batch[11])
        steps[contrib] = (float(loss), jax.tree_util.tree_map(np.asarray, new),
                          first_adam_grads(opt_state))
    return inputs, batch, steps


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    inputs, batch, steps = _jax(k)
    train_params = jax.tree_util.tree_map(
        np.asarray, init_hypergnn(HyperGNNConfig(**CFG), jax.random.PRNGKey(0)))
    train, _ = _case_inputs(3, train_params)
    all_inputs = {f"step/{key}": v for key, v in inputs.items()}
    all_inputs.update({f"train/{key}": v for key, v in train.items()})
    outs = spawn("torch_parallel_ranks_mb:distributed_minibatch", k,
                 tmp_path_factory.mktemp(f"dist_minibatch_k{k}"), all_inputs)
    return k, batch, steps, outs


def test_sample_batch_sharded_equals_jax(ranks):
    k, batch, _, outs = ranks
    for o in outs:
        assert int(o["batch/nodes_per_shard"]) == batch[0].nodes_per_shard
        for name, want in zip(BATCH_FIELDS, batch[1:]):
            want = np.asarray(want)
            got = o[f"batch/{name}"]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert batch[2].shape[0] % (k * 512) == 0  # the ladder bucket


@pytest.mark.parametrize("contrib", CONTRIBS)
def test_one_step_matches_jax_with_its_negatives(ranks, contrib):
    _, _, steps, outs = ranks
    loss, params, grads = steps[contrib]
    for o in outs:
        np.testing.assert_allclose(o[f"{contrib}/loss"][0], loss, rtol=0, atol=1e-5)
        assert_adam_step_close(o, contrib, params, grads, lr=LR)


def test_trainer_step_matches_the_single_card_trainer(ranks):
    _, _, _, outs = ranks
    for o in outs:
        np.testing.assert_allclose(o["trainer/loss"][0], o["single/loss"][0], rtol=0,
                                   atol=1e-5)
        # The replicated draw from one generator state: the single card's.
        np.testing.assert_allclose(o["trainer/gen_loss"][0], o["single/gen_loss"][0],
                                   rtol=0, atol=1e-5)
        for key in o:
            if key.startswith("single/param/"):
                np.testing.assert_allclose(o["trainer" + key[6:]], o[key], rtol=0, atol=ATOL,
                                           err_msg=key)
        np.testing.assert_array_equal(o["trainer/loss"], o["dense/loss"])


def test_loss_decreases_with_one_bucket(ranks):
    _, _, _, outs = ranks
    losses = outs[0]["train/losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    for o in outs:
        assert int(o["train/buckets"]) == 1
        np.testing.assert_array_equal(o["train/losses"], losses)


def test_refuses_what_jax_refuses_and_more(ranks):
    _, _, _, outs = ranks
    errs = {key[4:]: outs[0][key].item() for key in outs[0] if key.startswith("err/")}
    assert "must divide the mesh axis" in errs["batch_size"]
    assert "node_bucket_multiple must divide" in errs["node_bucket"]
    assert "needs rel_group_sizes" in errs["grouped_no_sizes"]
    # Stricter than JAX, which takes an unknown contribution as dense.
    assert "unknown contrib backend" in errs["cuda"]
    assert "needs gen or neg_dst" in errs["no_negatives"]
