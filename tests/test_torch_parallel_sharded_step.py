"""The port's ``make_train_step`` over the DTensors of
``parallel.shard_params`` / ``shard_graph_arrays``, on k gloo ranks (mesh
("edge",) of 2 at k = 2, ("edge", "model") of 2 × 2 at k = 4), against the
JAX package's single-device step: the twin of
``tests/test_sharding.py::TestShardedTrainStep`` and of
``__graft_entry__.dryrun_multichip``.

The loss within 1e-5 (test_sharding.py:131), the gradients and the
parameters after Adam as ``torch_composed_cases.assert_adam_step_close``
holds them, every parameter still placed as ``hypergnn_param_shardings``
says (its local block the block of its whole value), and the speed-mode
step under the same placements finite.

One spawn of k ranks per world size (``torch_parallel_ranks_cd.sharded_step``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu.training.train import make_train_step
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_composed_cases import assert_adam_step_close, encoded, first_adam_grads, rank_inputs
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
N, E, U, LR = 24, 64, 5, 1e-3
CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16, num_layers=2)


@functools.lru_cache(maxsize=1)
def _case():
    """test_sharding.py's graph: n=24, e=64, u=5; parameters from PRNGKey(0)."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((N, 8)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, size=E), rng.integers(0, N, size=E)]).astype(np.int64)
    ridx = rng.integers(0, U, size=E)
    params = jax.tree_util.tree_map(np.asarray, init_hypergnn(CONFIG, jax.random.PRNGKey(0)))
    return ei, ridx, feats, CONFIG, params


@functools.lru_cache(maxsize=1)
def _jax():
    """JAX's single-device step with rng PRNGKey(7), and its negatives."""
    ei, ridx, feats, config, params = _case()
    graph = encoded(_case(), N)
    optimizer = optax.adam(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(7)
    new, opt_state, loss = make_train_step(config, optimizer)(
        jparams, optimizer.init(jparams), jnp.asarray(feats),
        *(jnp.asarray(a) for a in graph.arrays), rng)
    neg = jax.random.randint(jax.random.split(rng, 3)[0], graph.src.shape, 0, N,
                             dtype=graph.src.dtype)
    return (float(loss), jax.tree_util.tree_map(np.asarray, new), np.asarray(neg),
            first_adam_grads(opt_state))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    want = _jax()
    inputs = {f"step/{key}": v for key, v in rank_inputs(_case(), N, neg=want[2]).items()}
    outs = spawn("torch_parallel_ranks_cd:sharded_step", k,
                 tmp_path_factory.mktemp(f"sharded_step_k{k}"), inputs)
    return want, outs


def test_sharded_step_matches_single_device(ranks):
    (loss, params, _, grads), outs = ranks
    for o in outs:
        assert np.isfinite(float(o["loss"]))
        np.testing.assert_allclose(float(o["loss"]), loss, atol=1e-5)
        assert_adam_step_close(o, "step", dict(named_leaves(params)),
                               dict(named_leaves(grads)), lr=LR)


def test_sharded_step_keeps_the_placements(ranks):
    _, outs = ranks
    sharded = 0
    for o in outs:
        for path, _ in named_leaves(_case()[4]):
            got = o[f"placement/{path}"].item()
            assert got == o[f"want_placement/{path}"].item(), path
            whole, local = o[f"step/param/{path}"], o[f"local/{path}"]
            if "S(" in got:
                sharded += 1
                assert local.size < whole.size, path
            else:
                np.testing.assert_array_equal(local, whole, err_msg=path)
    # The heads' last Linears are split on "model", which only the 2 × 2
    # mesh has.
    assert (sharded > 0) == (len(outs) == 4)


def test_sharded_speed_mode_step_runs(ranks):
    _, outs = ranks
    for o in outs:
        assert np.isfinite(float(o["bf16_loss"]))
