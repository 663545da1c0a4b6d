"""The composed steps' cases for the port's CPU tests: graphs drawn as
``tests/test_composed.py``'s ``_setup`` draws them, the JAX package's step
run on k virtual CPU devices, and the inputs a rank body
(``torch_parallel_ranks_cd``) rebuilds the same case from."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu.parallel.composed import (
    make_composed_train_step,
    prepare_composed_inputs,
)
from graph_hypernetwork_forge_tpu.parallel.composed_tp import (
    make_composed_tp_train_step,
    shard_composed_tp_params,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import assert_scaled_close

LR = 1e-2
# Below this |gradient| Adam's first step, lr·g/(|g| + eps), moves with the
# rounding of g: two summation orders may move such a parameter by anything
# up to 2·lr (a flipped sign). Above it the step's parameters are held to
# the gradient gate.
NOISE_GRAD = 1e-6


def assert_adam_step_close(out: dict, prefix: str, params: dict, grads: dict,
                           lr: float = LR) -> None:
    """The port's step (``out[prefix/param/...]`` and ``/grad/...``)
    against JAX's parameters after Adam and gradients: gradients at 3e-5
    after dividing by max(1, max|JAX|); parameters there too wherever the
    gradient is above the rounding floor, and within 2·lr elsewhere."""
    grads = dict(named_leaves(grads))
    for path, want in grads.items():
        assert_scaled_close(out[f"{prefix}/grad/{path}"], want, err_msg=path)
    for path, want in named_leaves(params):
        got, sure = out[f"{prefix}/param/{path}"], np.abs(grads[path]) >= NOISE_GRAD
        assert_scaled_close(np.where(sure, got, want), want, err_msg=path)
        assert np.abs(got - want).max(initial=0.0) <= 2 * lr, path


def first_adam_grads(opt_state):
    """The gradients of a first optax Adam step: its first moment over 1 - b1."""
    mu = opt_state[0].mu
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu)


@functools.lru_cache(maxsize=None)
def raw_case(seed, n=26, e=100, u=6, f=8, hidden=16, dropout=0.0, text_dim=16):
    """``(ei, relation indices, feats, config, params)`` of test_composed.py's
    ``_setup`` (n nodes); the texts are ``relation kind i``."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ridx = rng.integers(0, u, e)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    config = HyperGNNConfig(text_dim=text_dim, node_feat_dim=f, hidden_dim=hidden,
                            num_layers=2, dropout=dropout)
    params = jax.tree_util.tree_map(np.asarray, init_hypergnn(config, jax.random.PRNGKey(3)))
    return ei, ridx, feats, config, params


def encoded(case, n):
    ei, ridx, *_ = case
    return encode_graph(ei, [f"relation kind {i}" for i in ridx], n)


def rank_inputs(case, n, **extra) -> dict:
    """What a rank body needs to rebuild ``case`` with the port."""
    ei, ridx, feats, config, params = case
    out = dict(ei=ei, ridx=ridx, n=np.int64(n), feats=feats,
               dims=np.array([config.text_dim, config.node_feat_dim, config.hidden_dim,
                              config.num_layers]),
               dropout=np.float32(config.dropout), **extra)
    out.update({f"params/{p}": a for p, a in named_leaves(params)})
    return out


def _arrays(inputs):
    return tuple(jnp.asarray(a) for a in (
        inputs.feats, inputs.src, inputs.dst, inputs.rel_ids, inputs.edge_mask,
        inputs.char_ids, inputs.lengths))


def jax_step(case, n, k, *, rng_seed, halo, contrib="dense", agg_sorted=False,
             scheduled=False, rel_sort_local=False, group_pad=0):
    """JAX's composed step on k devices: ``(loss, params after Adam, the
    negatives it drew)``: each shard's rotation (local_roll, halo mode) or
    the whole ``[k·cap]`` uniform negatives (dense v1)."""
    _, _, feats, config, params = case
    mesh = make_mesh((k,), ("edge",), devices=jax.devices()[:k])
    inputs = prepare_composed_inputs(encoded(case, n), feats, k, halo=halo,
                                     rel_sort_local=rel_sort_local, scheduled=scheduled,
                                     group_pad=group_pad)
    optimizer = optax.adam(LR)
    step = make_composed_train_step(
        mesh, config, optimizer, inputs.nodes_per_shard, num_nodes=inputs.num_nodes,
        halo_width=inputs.halo_width if halo else None, contrib=contrib,
        agg_sorted=agg_sorted,
        scheduled_rounds=inputs.sched_round_perms if scheduled else None,
    )
    kw = {}
    if halo:
        kw["src_halo"] = jnp.asarray(inputs.src_halo)
        kw["send_idx"] = (tuple(jnp.asarray(t) for t in inputs.sched_send_tables)
                          if scheduled else jnp.asarray(inputs.send_idx))
    if contrib == "grouped":
        kw["rel_group_sizes"] = jnp.asarray(inputs.rel_group_sizes)
    if agg_sorted:
        kw["agg_plan"] = tuple(jnp.asarray(a) for a in inputs.agg_plan)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(rng_seed)
    new, opt_state, loss = step(jparams, optimizer.init(jparams), *_arrays(inputs), rng, **kw)
    neg_rng = jax.random.split(rng)[0]
    cap = inputs.src.shape[0] // k
    if halo:
        neg = dict(shifts=np.array([
            int(jax.random.randint(jax.random.fold_in(neg_rng, j), (), 1, max(cap, 2)))
            for j in range(k)]))
    else:
        neg = dict(neg=np.asarray(jax.random.randint(
            neg_rng, inputs.src.shape, 0, inputs.num_nodes, dtype=inputs.src.dtype)))
    return (float(loss), jax.tree_util.tree_map(np.asarray, new), neg,
            first_adam_grads(opt_state))


def jax_tp_step(case, n, k_e, k_m, *, rng_seed, contrib):
    """JAX's 2D composed step on a (k_e, k_m) mesh: ``(loss, params after
    Adam (whole), each edge shard's rotation)``."""
    _, _, feats, config, params = case
    mesh = make_mesh((k_e, k_m), ("edge", "model"), devices=jax.devices()[: k_e * k_m])
    inputs = prepare_composed_inputs(encoded(case, n), feats, k_e, halo=True,
                                     rel_sort_local=contrib == "grouped")
    optimizer = optax.adam(LR)
    sharded = shard_composed_tp_params(jax.tree_util.tree_map(jnp.asarray, params), config,
                                       mesh)
    step = make_composed_tp_train_step(mesh, config, optimizer, inputs.nodes_per_shard,
                                       halo_width=inputs.halo_width, contrib=contrib)
    kw = dict(src_halo=jnp.asarray(inputs.src_halo), send_idx=jnp.asarray(inputs.send_idx))
    if contrib == "grouped":
        kw["rel_group_sizes"] = jnp.asarray(inputs.rel_group_sizes)
    rng = jax.random.PRNGKey(rng_seed)
    new, opt_state, loss = step(sharded, optimizer.init(sharded), *_arrays(inputs), rng,
                                **kw)
    neg_rng = jax.random.split(rng)[0]
    cap = inputs.src.shape[0] // k_e
    shifts = np.array([
        int(jax.random.randint(jax.random.fold_in(neg_rng, j), (), 1, max(cap, 2)))
        for j in range(k_e)])
    return (float(loss), jax.tree_util.tree_map(np.asarray, new), shifts,
            first_adam_grads(opt_state))
