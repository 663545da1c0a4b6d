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

Distributed minibatching (BASELINE config #4: "Wikidata5M inductive:
neighbor-sampled minibatches, edge-partitioned across hosts"):
:func:`make_composed_minibatch_step` runs the composed step's dense v1
(``parallel/composed.py``) on a sampled subgraph, and
:class:`DistributedMinibatchTrainer` cuts each batch into per-shard blocks
of fixed bucket sizes for it.
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
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import _DENSE_BUDGET_ELEMENTS
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import copy, local_block
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.training.objectives import link_prediction_loss
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_map
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


# ---------------------------------------------------------------------------
# Distributed minibatching: neighbor-sampled subgraphs × the composed step
# ---------------------------------------------------------------------------

MINIBATCH_CONTRIBS = ("dense", "grouped")


def make_composed_minibatch_step(
    mesh,
    config: HyperGNNConfig,
    optimizer: Optimizer,
    nodes_per_shard: int,
    *,
    axis: str = "edge",
    margin: float = 1.0,
    contrib: str = "dense",
):
    """The edge-sharded minibatch train step (forward, backward, Adam).

    Returns ``step(params, opt_state, feats, src, dst, rel, mask, chars,
    lens, pos_src, pos_dst, pos_mask, gen=None, rel_group_sizes=None,
    neg_dst=None) → (params, opt_state, loss)``. Every array is this rank's
    block of :meth:`DistributedMinibatchTrainer.sample_batch_sharded`'s
    shard-major arrays (``collectives.local_block``); ``params`` are whole
    and the same on every rank, and enter the per-rank work through
    ``copy``; ``opt_state`` is the ``torch.optim.Optimizer`` over their
    leaves, stepped identically on every rank. The loss is replicated.

    The subgraph is sharded as in ``parallel/composed.py``'s dense v1: one
    ``all_gather`` of the whole h a layer (a halo plan would change shape
    every batch). The positives are sharded too. The negatives are drawn
    replicated, ``[batch_size]`` ids over the padded node count
    ``k · nodes_per_shard`` from ``gen`` (the draw of
    :meth:`MinibatchTrainer.device_step`, so the same generator state gives
    the single-card step's negatives), and each rank scores its block;
    ``neg_dst`` (the whole ``[batch_size]``) replaces the draw. No dropout
    is drawn, whatever ``config.dropout`` says, as in the JAX step.

    ``contrib``: ``"dense"`` (the all-relations ``[2U, n, d]`` product) or
    ``"grouped"`` (one product per relation group of the shard's sorted
    edges; needs ``rel_group_sizes``, the rank's ``[1, U_pad]`` block, whose
    values the host reads: keep it on the host to spare a wait). The
    JAX step takes any other value as ``"dense"``; the port refuses it. It
    offers no kernel contribution, as JAX's minibatch step has none.
    """
    # parallel/composed.py imports training.train: imported here, not at
    # the top, so neither package's import needs the other finished.
    from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
        _composed_layers,
        _dense_exchange,
        _masked_mean,
    )

    if contrib not in MINIBATCH_CONTRIBS:
        raise ValueError(
            f"unknown contrib backend for the minibatch step: {contrib!r} "
            f"(one of {MINIBATCH_CONTRIBS})"
        )
    npp = nodes_per_shard
    k = mesh_axis_size(mesh, axis)
    exchange = _dense_exchange(mesh, axis)

    def step(params, opt_state: torch.optim.Optimizer, feats, src, dst, rel, mask, chars,
             lens, pos_src, pos_dst, pos_mask, gen: Optional[torch.Generator] = None,
             rel_group_sizes=None, neg_dst=None):
        if contrib == "grouped" and rel_group_sizes is None:
            raise ValueError("contrib='grouped' needs rel_group_sizes "
                             "(sample_batch_sharded's group sizes)")
        if neg_dst is None:
            if gen is None:
                raise ValueError("the minibatch step needs gen or neg_dst")
            neg_dst = torch.randint(
                0, k * npp, (k * pos_src.shape[0],), generator=gen,
                device=feats.device, dtype=pos_src.dtype,
            )
        neg_l = local_block(neg_dst, mesh, axis)
        opt_state.zero_grad(set_to_none=True)
        p = tree_map(lambda t: copy(t, mesh, axis), params)
        h = _composed_layers(
            mesh, config, p, npp, axis, feats, src, dst, rel, mask, chars, lens, exchange,
            halo=False, contrib=contrib,
            sizes=rel_group_sizes[0].tolist() if contrib == "grouped" else None,
        )
        embs = exchange(h)
        head = embs.index_select(0, pos_src)
        pos = (head * embs.index_select(0, pos_dst)).sum(-1)
        neg = (head * embs.index_select(0, neg_l)).sum(-1)
        loss = _masked_mean((margin - pos + neg).clamp(min=0.0) * pos_mask, pos_mask,
                            mesh, axis)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


class DistributedMinibatchTrainer(MinibatchTrainer):
    """Neighbor-sampled minibatches × the edge-sharded composed step.

    Each sampled subgraph is dst-partitioned over the mesh axis
    (``prepare_composed_inputs(halo=False, rel_sort_local=True)``) and every
    per-shard array is padded to a ladder bucket (the per-shard edge cap
    rounded up to ``cap_multiple``), so batches share shapes and
    ``_dist_steps`` holds one step per bucket, keyed as the JAX trainer
    keys its compiled programs. Positives are padded to
    ``spec.batch_size``, which the axis must divide, and sharded too.

    Every rank samples the same batch from the same ``rng_np``, as every
    JAX host runs the same program, and keeps only its blocks: the sampler
    (the native one included) must stay deterministic across processes.
    The flow is :meth:`sample_batch_sharded` (host), :meth:`to_device` (the
    rank's blocks to ``device``), :meth:`device_step`; :meth:`step` runs
    the three. ``params`` and ``opt_state`` are as the single-card
    trainer's, whole on every rank.
    """

    def __init__(self, mesh, config: HyperGNNConfig, optimizer: Optimizer, edge_index,
                 edge_texts, node_features, spec: Optional[MinibatchSpec] = None, *,
                 axis: str = "edge", margin: float = 1.0, cap_multiple: int = 512,
                 device=None) -> None:
        self.mesh = mesh
        self.axis = axis
        self.num_shards = mesh_axis_size(mesh, axis)
        self.cap_multiple = cap_multiple
        spec = spec or MinibatchSpec()
        if spec.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size ({spec.batch_size}) must divide the mesh "
                f"axis ({self.num_shards})"
            )
        if spec.node_bucket_multiple % self.num_shards:
            raise ValueError(
                "node_bucket_multiple must divide the mesh axis so the "
                "padded node count shards evenly (and the negative-"
                "sampling range matches the single-device trainer)"
            )
        super().__init__(config, optimizer, edge_index, edge_texts, node_features, spec,
                         margin=margin, device=device)
        self._dist_steps: dict = {}

    def shard_batch(self, batch) -> tuple:
        """A :meth:`sample_batch` result as per-shard fixed-bucket composed
        arrays, shard-major numpy: ``(inputs, feats, src, dst, rel, mask,
        chars, lens, pos_src, pos_dst, pos_mask, rel_group_sizes)``."""
        from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
            prepare_composed_inputs,
        )

        feats, graph, pos_src, pos_dst, pos_mask = batch
        k = self.num_shards
        # Partition over the bucket-padded node count, so feats and npp line
        # up with the single-card trainer's node range (pad nodes are
        # isolated, and the negatives' range is the same).
        graph = dataclasses.replace(graph, num_nodes=feats.shape[0])
        inputs = prepare_composed_inputs(graph, feats, k, halo=False, rel_sort_local=True)
        # The ladder pad of the per-shard edge cap. Pad rows carry the last
        # relation id, so each shard stays relation-sorted with contiguous
        # groups, mask 0, and a dst the shard owns.
        cap = inputs.src.shape[0] // k
        cap_b = round_up_to_multiple(cap, self.cap_multiple)
        npp = inputs.nodes_per_shard
        u_pad = inputs.char_ids.shape[0]

        def grow(arr, fill):
            arr = np.asarray(arr)
            out = np.full((k, cap_b), fill, dtype=arr.dtype)
            out[:, :cap] = arr.reshape(k, cap)
            return out

        src = grow(inputs.src, 0).reshape(-1)
        rel = grow(inputs.rel_ids, u_pad - 1).reshape(-1)
        mask = grow(inputs.edge_mask, 0).reshape(-1)
        dst = grow(inputs.dst, 0)
        dst[:, cap:] = (np.arange(k) * npp)[:, None]
        gs = np.array(inputs.rel_group_sizes, dtype=np.int32)
        gs[:, -1] += cap_b - cap
        return (inputs, inputs.feats, src, dst.reshape(-1), rel, mask, inputs.char_ids,
                inputs.lengths, pos_src, pos_dst, pos_mask, gs)

    def sample_batch_sharded(self, rng: np.random.Generator) -> tuple:
        """One subgraph batch as per-shard fixed-bucket composed arrays (the
        JAX trainer's arrays, numpy): :meth:`shard_batch` of
        :meth:`sample_batch`."""
        return self.shard_batch(self.sample_batch(rng))

    def to_device(self, sharded) -> tuple:
        """This rank's blocks of a :meth:`sample_batch_sharded` result as
        tensors (only the blocks are copied): ``(feats, src, dst, rel, mask,
        chars, lens, pos_src, pos_dst, pos_mask)`` on the trainer's device,
        then ``rel_group_sizes`` on the host, where ``grouped`` reads its
        group sizes without waiting for the card."""
        blocks = tuple(
            local_block(torch.from_numpy(np.ascontiguousarray(a)), self.mesh, self.axis)
            for a in sharded[1:]
        )
        return tuple(t.to(self.device) for t in blocks[:-1]) + blocks[-1:]

    def _pick_contrib(self, n_pad: int, u_pad: int) -> str:
        # The single-card auto backend's memory regime: the dense [2U, n, d]
        # product beyond the budget goes grouped.
        dense_elems = 2 * u_pad * n_pad * self.config.hidden_dim
        return "dense" if dense_elems <= _DENSE_BUDGET_ELEMENTS else "grouped"

    def device_step(self, params, opt_state: torch.optim.Optimizer, tensors: tuple,
                    gen: Optional[torch.Generator] = None,
                    neg_dst: Optional[torch.Tensor] = None):
        """One distributed step over :meth:`to_device`'s blocks, through the
        step of the batch's bucket (built on first use). Negatives as in
        :func:`make_composed_minibatch_step`."""
        k = self.num_shards
        npp, rows, u_pad = (tensors[0].shape[0], k * tensors[1].shape[0],
                            k * tensors[5].shape[0])
        contrib = self._pick_contrib(k * npp, u_pad)
        key = (npp, rows, u_pad, contrib)
        if key not in self._dist_steps:
            self._dist_steps[key] = make_composed_minibatch_step(
                self.mesh, self.config, self.optimizer, npp, axis=self.axis,
                margin=self.margin, contrib=contrib,
            )
        return self._dist_steps[key](params, opt_state, *tensors[:10], gen=gen,
                                     rel_group_sizes=tensors[10], neg_dst=neg_dst)

    def step(self, params, opt_state: torch.optim.Optimizer, rng_np: np.random.Generator,
             gen: Optional[torch.Generator] = None, neg_dst: Optional[torch.Tensor] = None):
        """Sample a batch on the host (every rank the same) and take one
        distributed step on the rank's blocks."""
        tensors = self.to_device(self.sample_batch_sharded(rng_np))
        return self.device_step(params, opt_state, tensors, gen, neg_dst)
