"""Pipeline parallelism: HyperGNN layers staged over a ``"pipe"`` axis.

The port of ``graph_hypernetwork_forge_tpu/parallel/pipeline.py``: GPipe
over ``torch.distributed`` ranks. The per-layer parameter lists are stacked
``[L, ...]`` (:func:`stack_layer_params`) and stage ``s`` runs layers
``[s·L/S, (s+1)·L/S)``. M microbatches of one static shape flow through the
ring in ``T = M + S − 1`` ticks: at tick ``t`` stage ``s`` runs microbatch
``t − s`` and hands its activation one hop on (``collectives.ppermute``);
the last stage keeps the finished microbatches, and a ``psum`` of its
masked outputs replicates ``[M, N, H]``. The input projection and the text
encoding are a replicated prelude.

Every stage applies the single-process layer function (message passing,
residual, ReLU, dropout, LayerNorm), so each microbatch's output is
``apply_hypergnn``'s.

*Bubble ticks.* JAX computes garbage on a tick where a stage holds no
microbatch and never writes it; here the stage runs nothing and passes its
input on. Every rank still posts each tick's exchange, and every exchange
stays in every rank's autograd graph (a zero-gradient sink keeps the
received activations reachable, and each tick's input depends on the
previous tick's exchange), so the backward runs the exchanges on every
rank in the same order: the autograd engine runs a rank's reachable nodes
in reverse creation order.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import apply_text_encoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    apply_weight_generator,
    draw_dropout_masks,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    relational_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    axis_index,
    copy,
    ppermute,
    psum,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.training.objectives import link_prediction_loss
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    layer_norm_apply,
    linear_apply,
    tree_map,
)


def _stack(trees: list) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _index(tree: Any, i) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, i) for v in tree]
    return tree[i]


def stack_layer_params(params: dict) -> tuple:
    """``(weight_generators, layer_norms)`` stacked along a leading layer
    axis ``[L, ...]``, from ``init_hypergnn``'s per-layer lists."""
    return _stack(params["weight_generators"]), _stack(params["layer_norms"])


class _Sink(torch.autograd.Function):
    """``out`` unchanged; the other inputs get zero gradients. It keeps
    every received activation reachable from the loss on every rank, so
    every rank runs every exchange's backward."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.others)


def _dropout_seeds(gen: torch.Generator, m: int, layers: int) -> list:
    """One seed per (microbatch, global layer), drawn whole on every rank,
    so a layer's masks do not depend on the stage that runs it (JAX's
    ``fold_in(fold_in(rng, mb), layer)``)."""
    return torch.randint(0, 2**62, (m, layers), generator=gen, device=gen.device).tolist()


def pipelined_forward(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    params: dict,
    node_features: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    edge_mask: Optional[torch.Tensor],
    char_ids: torch.Tensor,
    text_lengths: torch.Tensor,
    *,
    axis: str = "pipe",
    train: bool = False,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Forward M microbatches through a layer-staged pipeline → ``[M, N, H]``,
    replicated.

    ``params`` is the whole tree, as every rank holds it; the rank runs its
    stage's block of the stacked layers, which enters through
    :func:`copy`, so the backward leaves every rank the whole gradient.
    ``node_features`` ``[M, N, F]``, ``src``/``dst``/``rel_ids`` ``[M, E]``,
    ``edge_mask`` ``[M, E]`` (None: all real), ``char_ids`` ``[M, U, L]``,
    ``text_lengths`` ``[M, U]``, all whole. Dropout is on when ``train``
    and ``config.dropout > 0``; then ``gen`` (the same state on every rank)
    draws one seed per (microbatch, global layer) and each layer draws its
    masks from its own generator, outside ``config.remat``'s checkpoint,
    so they depend neither on the number of stages nor on the recompute.
    """
    n_stages = mesh_axis_size(mesh, axis)
    if config.num_layers % n_stages != 0:
        raise ValueError(
            f"num_layers={config.num_layers} must be divisible by the pipeline "
            f"axis size {n_stages}"
        )
    use_dropout = train and config.dropout > 0.0
    if use_dropout and gen is None:
        raise ValueError("dropout requires a torch.Generator in training mode")
    m, n = node_features.shape[0], node_features.shape[1]
    s = axis_index(mesh, axis)
    per_stage = config.num_layers // n_stages
    dev = node_features.device
    if edge_mask is None:
        edge_mask = torch.ones(src.shape, dtype=node_features.dtype, device=dev)
    seeds = _dropout_seeds(gen, m, config.num_layers) if use_dropout else None

    # Replicated prelude (reference models/hypergnn.py:261, :270).
    h0 = torch.relu(linear_apply(params["input_proj"], node_features,
                                 precision=config.precision))
    text = torch.stack([
        apply_text_encoder(params["text_encoder"], char_ids[mb], text_lengths[mb],
                           precision=config.precision)
        for mb in range(m)
    ])
    # Replicated values enter the per-stage work through copy: their
    # gradients sum over the stages. A stage reads its block of the layers.
    h0, text = copy(h0, mesh, axis), copy(text, mesh, axis)
    block = slice(s * per_stage, (s + 1) * per_stage)
    gens, norms = (_index(tree_map(lambda x: copy(x, mesh, axis), t), block)
                   for t in stack_layer_params(params))
    p = config.dropout
    wg_config = config.weight_generator

    def one_layer(h, mb, gen_p, norm_p, wg_keep, h_keep):
        weights = apply_weight_generator(wg_config, gen_p, text[mb], train=use_dropout,
                                         keep=wg_keep)
        h_new = relational_message_passing(
            h, src[mb], dst[mb], rel_ids[mb], weights["W_msg"], weights["W_self"],
            weights["bias"], num_nodes=n, edge_mask=edge_mask[mb],
            backend=config.backend, precision=config.precision,
            rel_sorted=config.rel_sorted,
        )
        h_new = torch.relu(h_new + h)
        if h_keep is not None:
            h_new = torch.where(h_keep, h_new / (1.0 - p), 0.0)
        return layer_norm_apply(norm_p, h_new)

    def run_stage(h, mb):
        for i in range(per_stage):
            wg_keep = h_keep = None
            if use_dropout:
                g = torch.Generator(device=dev).manual_seed(seeds[mb][s * per_stage + i])
                wg_keep = draw_dropout_masks(wg_config, text.shape[1], g)
                h_keep = torch.rand((n, config.hidden_dim), generator=g, device=dev) < 1.0 - p
            args = (h, mb, _index(gens, i), _index(norms, i), wg_keep, h_keep)
            h = (checkpoint(one_layer, *args, use_reentrant=False) if config.remat
                 else one_layer(*args))
        return h

    first = torch.tensor(s == 0, device=dev)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    state = torch.zeros((n, config.hidden_dim), dtype=h0.dtype, device=dev)
    outs, received = [None] * m, []
    n_ticks = m + n_stages - 1
    for t in range(n_ticks):
        mb = t - s
        active = 0 <= mb < m
        # Stage 0 takes a fresh microbatch, the others last tick's hand-over;
        # the select keeps the hand-over in the graph on stage 0 too.
        h_in = torch.where(first, h0[min(max(mb, 0), m - 1)], state)
        h_out = run_stage(h_in, mb) if active else h_in
        if active:
            outs[mb] = h_out
        if t < n_ticks - 1:
            state = ppermute(h_out, mesh, axis, ring)
            received.append(state)
    last = torch.tensor(s == n_stages - 1, device=dev)
    stacked = torch.stack(outs)
    out = psum(torch.where(last, stacked, torch.zeros_like(stacked)), mesh, axis)
    return _Sink.apply(out, *received)


def make_pipelined_train_step(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    optimizer: Optimizer,
    *,
    margin: float = 1.0,
    axis: str = "pipe",
) -> Callable:
    """The pipelined training step over M microbatched subgraphs.

    Returns ``step(params, opt_state, feats [M, N, F], src, dst, rel,
    mask, chars, lens, gen, neg_dst=None) → (params, opt_state, loss)``,
    every array whole and the same on every rank, ``opt_state`` the
    ``torch.optim.Optimizer`` over ``params``' leaves (``optimizer``, via
    ``training.create_train_state``), updated in place and identically on
    every rank. The loss is the mean over microbatches of the margin-ranking
    link-prediction loss; negatives ``[M, E]`` are uniform over the nodes,
    drawn from ``gen`` unless ``neg_dst`` is given, and then the dropout
    seeds are drawn from it (``config.dropout > 0``). Gradients run back
    through the ring (``ppermute``'s backward is the reverse hop).
    """
    use_dropout = config.dropout > 0.0

    def step(params, opt_state: torch.optim.Optimizer, feats, src, dst, rel, mask,
             chars, lens, gen: torch.Generator, neg_dst=None
             ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        if neg_dst is None:
            neg_dst = torch.randint(0, feats.shape[1], src.shape, generator=gen,
                                    device=src.device, dtype=src.dtype)
        opt_state.zero_grad(set_to_none=True)
        embs = pipelined_forward(mesh, config, params, feats, src, dst, rel, mask,
                                 chars, lens, axis=axis, train=use_dropout, gen=gen)
        loss = torch.stack([
            link_prediction_loss(embs[mb], src[mb], dst[mb], neg_dst[mb], margin=margin,
                                 edge_mask=mask[mb])
            for mb in range(feats.shape[0])
        ]).mean()
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step

