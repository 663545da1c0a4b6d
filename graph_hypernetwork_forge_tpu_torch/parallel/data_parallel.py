"""Data parallelism: a batch of subgraphs sharded over ``"data"``.

The port of ``graph_hypernetwork_forge_tpu/parallel/data_parallel.py``. A
batch of B subgraphs of one static shape (``data/encoding.py``'s padding)
is split over the ``"data"`` axis, B/k to a rank; the parameters and the
optimizer state are replicated. The loss is the mean over all B of the
link-prediction loss, each rank's sum divided by B and summed over the
axis; the parameters' gradients are summed over the axis in the backward
(``collectives.copy``), so every rank takes the same Adam update.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNNConfig,
    apply_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import copy, psum
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.training.objectives import link_prediction_loss
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_map


def make_data_parallel_step(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    optimizer: Optimizer,
    *,
    margin: float = 1.0,
    axis: str = "data",
) -> Callable:
    """The DP training step over a leading batch axis of subgraphs.

    Returns ``step(params, opt_state, feats [B/k, N, F], src [B/k, E], dst,
    rel, mask, chars, lens, gen, neg=None) → (params, opt_state, loss)``,
    every array this rank's block of the batch, ``params`` and ``opt_state``
    replicated. ``opt_state`` is the ``torch.optim.Optimizer`` over the
    leaves of ``params`` that ``optimizer`` (``training.adam``, JAX's
    ``optax`` argument) made, through ``training.create_train_state``; the
    update is in place. Negatives ``[B/k, E]`` are drawn uniformly over the
    nodes from ``gen``, this rank's generator, unless ``neg`` is given; the
    dropout masks, when ``config.dropout > 0``, come from ``gen`` too. The
    loss is a 0-d tensor, replicated.
    """
    k = mesh_axis_size(mesh, axis)
    use_dropout = config.dropout > 0.0

    def step(params, opt_state: torch.optim.Optimizer, feats, src, dst, rel,
             mask, chars, lens, gen: torch.Generator, neg=None
             ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        if neg is None:
            neg = torch.randint(0, feats.shape[1], src.shape, generator=gen,
                                device=src.device, dtype=src.dtype)
        opt_state.zero_grad(set_to_none=True)
        p = tree_map(lambda t: copy(t, mesh, axis), params)
        local = sum(
            link_prediction_loss(
                apply_hypergnn(config, p, feats[b], src[b], dst[b], rel[b], mask[b],
                               chars[b], lens[b], train=use_dropout, gen=gen),
                src[b], dst[b], neg[b], margin=margin, edge_mask=mask[b],
            )
            for b in range(feats.shape[0])
        )
        loss = psum(local / (feats.shape[0] * k), mesh, axis)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step
