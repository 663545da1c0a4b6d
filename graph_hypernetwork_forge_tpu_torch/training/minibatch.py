"""Minibatch link-prediction training over neighbor-sampled subgraphs.

The counterpart of the JAX package's ``training/minibatch.py``
(``MinibatchSpec``, ``MinibatchTrainer``): sample a batch of positive
edges, expand the k-hop in-neighborhood of their endpoints
(``data/sampling.py``), and take one margin-ranking step on the subgraph.
Nodes are padded to a multiple of ``node_bucket_multiple`` and positives to
``batch_size``, with masks that make the padding inert, as the JAX trainer
pads them for one compiled program; the port keeps the shapes so that both
packages compute the same step.

The sampled subgraph is not relation-sorted, so ``backend="auto"`` picks
``dense`` or ``grouped`` by size as the JAX package does, and no CUDA kernel
runs. Negative tails are drawn over the padded node range, as JAX draws
them (a reference behaviour the port matches and flags): from a
``torch.Generator`` on the device, or handed in as ``neg_dst``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.data.sampling import NeighborSampler
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNNConfig,
    apply_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.training.objectives import link_prediction_loss
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple


@dataclasses.dataclass
class MinibatchSpec:
    batch_size: int = 128  # positive edges per step
    fanouts: Tuple[int, ...] = (10, 10)
    node_bucket_multiple: int = 256


class MinibatchTrainer:
    """Host-side sampler and one train step on the device over padded
    subgraphs.

    ``optimizer`` is the factory the caller's state is made with
    (``training.adam``, kept as ``self.optimizer`` beside the JAX trainer's
    optax transform); the step takes the ``torch.optim.Optimizer`` it made
    as ``opt_state``, over the leaves of ``params`` on ``device`` (None:
    the CUDA card).
    """

    def __init__(
        self,
        config: HyperGNNConfig,
        optimizer: Optimizer,
        edge_index: np.ndarray,
        edge_texts,
        node_features: np.ndarray,
        spec: Optional[MinibatchSpec] = None,
        *,
        margin: float = 1.0,
        device=None,
    ) -> None:
        self.config = config
        self.optimizer = optimizer
        self.spec = spec or MinibatchSpec()
        self.margin = margin
        self.device = resolve_device(device)
        self.edge_index = np.asarray(edge_index)
        self.edge_texts = list(edge_texts)
        self.node_features = np.asarray(node_features, dtype=np.float32)
        self.num_nodes = self.node_features.shape[0]
        self.sampler = NeighborSampler(self.edge_index, self.edge_texts, self.num_nodes)

    def sample_batch(self, rng: np.random.Generator):
        """Draw positive edges, expand the neighborhood, bucket-pad:
        ``(feats [N_pad, F], graph, pos_src, pos_dst, pos_mask)``, numpy."""
        spec = self.spec
        e_total = self.edge_index.shape[1]
        pos_ids = rng.integers(0, e_total, size=min(spec.batch_size, e_total))
        pos_src_g = self.edge_index[0][pos_ids]
        pos_dst_g = self.edge_index[1][pos_ids]
        seeds = np.unique(np.concatenate([pos_src_g, pos_dst_g]))

        batch = self.sampler.sample(seeds, spec.fanouts, self.node_features, rng=rng)

        # Nodes padded to the bucket; the graph keeps its real node count
        # (its ids stay below it), the model runs over the padded rows.
        n_real = len(batch.node_ids)
        n_pad = round_up_to_multiple(n_real, spec.node_bucket_multiple)
        feats = np.zeros((n_pad, self.node_features.shape[1]), np.float32)
        feats[:n_real] = batch.node_features

        # Positive pairs in local ids (node_ids is sorted), padded to batch_size.
        b = spec.batch_size
        pos_src = np.zeros(b, np.int32)
        pos_dst = np.zeros(b, np.int32)
        pos_mask = np.zeros(b, np.float32)
        k = len(pos_ids)
        pos_src[:k] = np.searchsorted(batch.node_ids, pos_src_g)
        pos_dst[:k] = np.searchsorted(batch.node_ids, pos_dst_g)
        pos_mask[:k] = 1.0
        return feats, batch.graph, pos_src, pos_dst, pos_mask

    def to_device(self, batch) -> tuple:
        """A :meth:`sample_batch` result as tensors on the trainer's device:
        ``(feats, *graph.arrays, pos_src, pos_dst, pos_mask)``."""
        feats, graph, pos_src, pos_dst, pos_mask = batch
        arrays = (feats, *graph.arrays, pos_src, pos_dst, pos_mask)
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def device_step(
        self,
        params: Any,
        opt_state: torch.optim.Optimizer,
        tensors: tuple,
        gen: Optional[torch.Generator] = None,
        neg_dst: Optional[torch.Tensor] = None,
    ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        """Forward, loss, backward and one optimizer update over a batch
        from :meth:`to_device`. Negatives come from ``gen`` (a generator on
        the device) over the padded node range unless ``neg_dst`` is given.
        The update is in place; ``loss`` is a 0-d tensor on the device."""
        feats, src, dst, rel, emask, cids, lens, pos_src, pos_dst, pos_mask = tensors
        if neg_dst is None:
            if gen is None:
                raise ValueError("device_step needs gen or neg_dst")
            neg_dst = torch.randint(
                0, feats.shape[0], pos_src.shape, generator=gen,
                device=feats.device, dtype=pos_src.dtype,
            )
        opt_state.zero_grad(set_to_none=True)
        embs = apply_hypergnn(self.config, params, feats, src, dst, rel, emask, cids, lens)
        loss = link_prediction_loss(
            embs, pos_src, pos_dst, neg_dst, margin=self.margin, edge_mask=pos_mask
        )
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    def step(
        self,
        params: Any,
        opt_state: torch.optim.Optimizer,
        rng_np: np.random.Generator,
        gen: Optional[torch.Generator] = None,
        neg_dst: Optional[torch.Tensor] = None,
    ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        """Sample a batch on the host and take one step on the device."""
        tensors = self.to_device(self.sample_batch(rng_np))
        return self.device_step(params, opt_state, tensors, gen, neg_dst)

