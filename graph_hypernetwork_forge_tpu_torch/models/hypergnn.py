"""HyperGNN: hypernetwork-conditioned GNN for zero-shot KG reasoning.

The port of ``graph_hypernetwork_forge_tpu/models/hypergnn.py``::

    relation texts ──TextEncoder──▶ [U, text_dim]
    [U, text_dim] ──WeightGenerator (one per layer)──▶ (W_msg, W_self, bias) [U, ·]
    per layer:  relation-conditioned message passing → +residual → ReLU
                → LayerNorm
    output: [N, hidden_dim] node embeddings; ``score_triple`` = dot product.

The semantics are the JAX package's: input projection + ReLU, relation
texts encoded once and shared by all layers, one WeightGenerator per layer
with ``hidden_dim=max(64, 2*text_dim)`` and two hidden layers, one
LayerNorm per layer, the count-clamped mean aggregation, a residual on
every layer. Relation identity enters only through the text.

Training mode puts dropout after each layer's residual ReLU (and in the
weight generators' hidden layers), its masks drawn from an explicit
``torch.Generator``; ``remat`` recomputes each layer in the backward
through ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_hypernetwork_forge_tpu_torch.data.encoding import (
    GROUP_PAD,
    EncodedGraph,
    encode_graph,
    validate_graph_for_config,
)
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import (
    TextEncoderConfig,
    apply_text_encoder,
    init_text_encoder,
)
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    WeightGeneratorConfig,
    apply_weight_generator,
    draw_dropout_masks,
    init_weight_generator,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    Backend,
    relational_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.ops.scoring import score_pairs
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    layer_norm_apply,
    layer_norm_params,
    linear_apply,
    linear_params,
    named_leaves,
    tree_leaves,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class HyperGNNConfig:
    """The JAX package's config, field for field.

    ``rel_sorted`` and ``group_padded`` promise the edge layout of
    ``encode_graph(sort_by_relation=True, group_pad=256)``; wrong results
    follow if the layout is otherwise. The port runs ``precision="highest"``
    and ``compute_dtype="float32"`` only.
    """

    text_dim: int
    node_feat_dim: int
    hidden_dim: int
    num_layers: int = 2
    dropout: float = 0.0
    char_emb_dim: int = 32
    backend: Backend = "auto"
    precision: str = "highest"
    remat: bool = False
    rel_sorted: bool = False
    group_padded: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.num_layers < 1:
            raise ValueError("num_layers must be at least 1")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}"
            )

    @property
    def text_encoder(self) -> TextEncoderConfig:
        return TextEncoderConfig(
            text_dim=self.text_dim, char_emb_dim=self.char_emb_dim
        )

    @property
    def weight_generator(self) -> WeightGeneratorConfig:
        return WeightGeneratorConfig(
            text_dim=self.text_dim,
            d_in=self.hidden_dim,
            d_out=self.hidden_dim,
            hidden_dim=max(64, self.text_dim * 2),
            num_hidden=2,
            dropout=self.dropout,
        )


def init_hypergnn(config: HyperGNNConfig, gen: torch.Generator) -> dict:
    """The parameter tree, with the JAX package's keys, drawn from ``gen``."""
    return {
        "text_encoder": init_text_encoder(config.text_encoder, gen),
        "input_proj": linear_params(gen, config.node_feat_dim, config.hidden_dim),
        "weight_generators": [
            init_weight_generator(config.weight_generator, gen)
            for _ in range(config.num_layers)
        ],
        "layer_norms": [
            layer_norm_params(config.hidden_dim) for _ in range(config.num_layers)
        ],
    }


def apply_hypergnn(
    config: HyperGNNConfig,
    params: dict,
    node_features: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    edge_mask: torch.Tensor | None,
    char_ids: torch.Tensor,
    text_lengths: torch.Tensor,
    *,
    train: bool = False,
    gen: torch.Generator | None = None,
    return_all_layers: bool = False,
    sort_plan=None,
):
    """Forward pass over the encoded arrays → ``[N, hidden_dim]``.

    With ``return_all_layers=True``, the list of per-layer outputs
    (post-norm). ``sort_plan`` is the layout's SortPlan with tensors on the
    arrays' device. Dropout is active when ``train`` and ``config.dropout >
    0``, and then needs ``gen``, a generator on the arrays' device.
    """
    use_dropout = train and config.dropout > 0.0
    if use_dropout and gen is None:
        raise ValueError("dropout requires a torch.Generator in training mode")
    if config.precision != "highest" or config.compute_dtype != "float32":
        raise NotImplementedError(
            "the port runs precision='highest', compute_dtype='float32' only; "
            "the bf16 speed mode is not ported yet"
        )
    h = torch.relu(linear_apply(params["input_proj"], node_features))
    text_embs = apply_text_encoder(params["text_encoder"], char_ids, text_lengths)
    n = node_features.shape[0]
    p = config.dropout

    def layer_fn(h, gen_params, norm_params, wg_keep, h_keep):
        weights = apply_weight_generator(
            config.weight_generator, gen_params, text_embs, train=train,
            keep=wg_keep,
        )
        h_new = relational_message_passing(
            h,
            src,
            dst,
            rel_ids,
            weights["W_msg"],
            weights["W_self"],
            weights["bias"],
            num_nodes=n,
            edge_mask=edge_mask,
            backend=config.backend,
            rel_sorted=config.rel_sorted,
            sort_plan=sort_plan,
            group_padded=config.group_padded,
        )
        # residual (hidden → hidden) → ReLU → dropout → LayerNorm
        h_new = torch.relu(h_new + h)
        if h_keep is not None:
            h_new = torch.where(h_keep, h_new / (1.0 - p), 0.0)
        return layer_norm_apply(norm_params, h_new)

    per_layer: List[torch.Tensor] = []
    for gen_params, norm_params in zip(
        params["weight_generators"], params["layer_norms"]
    ):
        wg_keep = h_keep = None
        if use_dropout:
            # Drawn here, outside the checkpointed layer: the recompute of
            # a remat layer restores the global RNG state, not gen's, and
            # would otherwise draw other masks than the forward used.
            wg_keep = draw_dropout_masks(
                config.weight_generator, text_embs.shape[0], gen
            )
            h_keep = (
                torch.rand((n, config.hidden_dim), generator=gen, device=gen.device)
                < 1.0 - p
            )
        if config.remat:
            h = checkpoint(
                layer_fn, h, gen_params, norm_params, wg_keep, h_keep,
                use_reentrant=False,
            )
        else:
            h = layer_fn(h, gen_params, norm_params, wg_keep, h_keep)
        per_layer.append(h)
    return per_layer if return_all_layers else h


class HyperGNN(nn.Module):
    """``model(node_features [N, F], edge_index [2, E], edge_texts)`` →
    ``[N, hidden_dim]`` on ``device`` (``None`` = the CUDA card; the CPU
    only when asked for by name).

    :meth:`preprocess` encodes a graph in the layout the kernels need
    (relation-sorted, group-padded, with a sort plan), which the config
    promises. The parameters are the leaves of ``self.params``, a tree with
    the JAX package's keys, registered as this module's parameters.

    Like any ``nn.Module`` it starts in training mode: the forward records
    the graph for a backward and applies dropout, drawing its masks from a
    generator the model holds (seeded from ``seed``) unless one is passed.
    After :meth:`eval` the forward runs under ``torch.inference_mode()``.
    """

    def __init__(
        self,
        text_dim: int,
        node_feat_dim: int,
        hidden_dim: int,
        num_layers: int = 2,
        dropout: float = 0.0,
        char_emb_dim: int = 32,
        *,
        backend: Backend = "auto",
        seed: int = 0,
        device=None,
    ) -> None:
        super().__init__()
        self.config = HyperGNNConfig(
            text_dim=text_dim,
            node_feat_dim=node_feat_dim,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            dropout=dropout,
            char_emb_dim=char_emb_dim,
            backend=backend,
            rel_sorted=True,
            group_padded=True,
        )
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = tree_map(
            lambda t: nn.Parameter(t.to(self.device)),
            init_hypergnn(self.config, gen),
        )
        self.leaves = nn.ParameterDict(
            {path.replace(".", "/"): p for path, p in named_leaves(self.params)}
        )
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Copy a parameter tree with this model's keys and shapes (for
        instance ``convert.params_from_jax(...)``) into the parameters."""
        new = {path.replace(".", "/"): t for path, t in named_leaves(params)}
        if set(new) != set(self.leaves.keys()):
            raise KeyError(
                f"parameter tree keys differ: {sorted(set(new) ^ set(self.leaves))}"
            )
        for path, p in self.leaves.items():
            p.copy_(new[path])

    def preprocess(
        self, edge_index, edge_texts: Sequence[str], num_nodes: int
    ) -> EncodedGraph:
        """Host-side encode; reuse the result across calls."""
        return encode_graph(
            np.asarray(edge_index), edge_texts, num_nodes,
            sort_by_relation=True, with_sort_plan=True, group_pad=GROUP_PAD,
        )

    def forward_encoded(
        self, node_features, graph: EncodedGraph, *, gen: torch.Generator | None = None
    ) -> torch.Tensor:
        validate_graph_for_config(graph, self.config)
        mode = contextlib.nullcontext() if self.training else torch.inference_mode()
        with mode:
            feats = torch.as_tensor(
                node_features, dtype=torch.float32, device=self.device
            )
            src, dst, rel_ids, edge_mask, char_ids, lengths = (
                torch.as_tensor(a, device=self.device) for a in graph.arrays
            )
            plan = None if graph.sort_plan is None else graph.sort_plan.to(self.device)
            return apply_hypergnn(
                self.config, self.params, feats, src, dst, rel_ids, edge_mask,
                char_ids, lengths, train=self.training,
                gen=self.dropout_gen if gen is None else gen, sort_plan=plan,
            )

    def forward(
        self, node_features, edge_index, edge_texts: Sequence[str]
    ) -> torch.Tensor:
        num_nodes = int(node_features.shape[0])
        graph = self.preprocess(edge_index, edge_texts, num_nodes)
        return self.forward_encoded(node_features, graph)

    def score_triple(self, head_emb, tail_emb) -> torch.Tensor:
        """Dot-product link score; ``[d] → scalar`` or ``[B, d] → [B]``."""
        return score_pairs(torch.as_tensor(head_emb), torch.as_tensor(tail_emb))

    def num_parameters(self) -> int:
        """Total parameter count."""
        return sum(p.numel() for p in tree_leaves(self.params))
