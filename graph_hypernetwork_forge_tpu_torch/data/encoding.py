"""Host-side graph encoding: raw (edge_index, edge_texts) → padded arrays.

The same encoding as the JAX package (``graph_hypernetwork_forge_tpu/data/
encoding.py``), array for array: relation dedup in first-occurrence order,
char tokenization, edge and relation padding to buckets, the optional
relation-sorted and group-padded layouts, and the :class:`SortPlan` of
host-precomputed permutations and CSR bounds. Relation identity enters the
model only through the tokenized text.

Everything here is numpy; :meth:`SortPlan.to` moves a plan's arrays to a
torch device for the compute core.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.utils.shapes import (
    pad_bucket_edges,
    pad_bucket_relations,
)
from graph_hypernetwork_forge_tpu_torch.utils.text import tokenize_texts

# Rows per single-relation tile of the group-padded layout; the edge
# transform kernel's tile (``ops/cuda/edge_transform.py``).
GROUP_PAD = 256


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """Host-precomputed sort permutations and CSR bounds of one edge layout.

    All arrays are ``[E_pad]`` except ``in_degree`` (``[N]`` float32 masked
    in-edge count), ``rel_counts`` (``[U_pad]`` int32 edges per relation,
    masked padding edges included) and the ``*_splits`` CSR row bounds
    (``splits[i]`` = first row whose sorted id is ``>= i``; ``[N + 1]`` or
    ``[U_pad + 1]``). ``rel_splits`` describes the stored layout only when
    that layout is relation-sorted.

    Built with numpy arrays; :meth:`to` returns a copy holding torch tensors.
    """

    dst_perm: np.ndarray       # stable argsort of dst over the stored layout
    inv_dst_perm: np.ndarray   # inverse permutation of dst_perm
    dst_sorted: np.ndarray     # dst[dst_perm], non-decreasing
    src_perm: np.ndarray       # stable argsort of src over the stored layout
    inv_src_perm: np.ndarray
    src_sorted: np.ndarray     # src[src_perm], non-decreasing
    in_degree: np.ndarray
    rel_counts: np.ndarray
    dst_splits: np.ndarray | None = None
    src_splits: np.ndarray | None = None
    rel_splits: np.ndarray | None = None

    def to(self, device) -> "SortPlan":
        """The same plan with every array a torch tensor on ``device``
        (dtypes kept: int32 ids and bounds, float32 degrees)."""
        return SortPlan(**{
            f.name: None if (a := getattr(self, f.name)) is None
            else torch.as_tensor(a, device=device)
            for f in dataclasses.fields(self)
        })


def build_sort_plan(
    src: np.ndarray,
    dst: np.ndarray,
    rel_ids: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    num_rel_pad: int,
) -> SortPlan:
    """Compute the :class:`SortPlan` for one stored edge layout."""
    e = src.shape[0]
    arange = np.arange(e, dtype=np.int32)

    dst_perm = np.argsort(dst, kind="stable").astype(np.int32)
    inv_dst = np.empty(e, dtype=np.int32)
    inv_dst[dst_perm] = arange
    src_perm = np.argsort(src, kind="stable").astype(np.int32)
    inv_src = np.empty(e, dtype=np.int32)
    inv_src[src_perm] = arange

    # Masked padding edges point at node 0 and add 0 to its degree.
    in_degree = np.zeros(num_nodes, dtype=np.float32)
    np.add.at(in_degree, dst, edge_mask.astype(np.float32))

    rel_counts = np.bincount(rel_ids, minlength=num_rel_pad).astype(np.int32)

    dst_sorted = dst[dst_perm].astype(np.int32)
    src_sorted = src[src_perm].astype(np.int32)
    node_bounds = np.arange(num_nodes + 1, dtype=np.int32)
    rel_splits = np.zeros(num_rel_pad + 1, dtype=np.int32)
    np.cumsum(rel_counts, out=rel_splits[1:])

    return SortPlan(
        dst_perm=dst_perm,
        inv_dst_perm=inv_dst,
        dst_sorted=dst_sorted,
        src_perm=src_perm,
        inv_src_perm=inv_src,
        src_sorted=src_sorted,
        in_degree=in_degree,
        rel_counts=rel_counts,
        dst_splits=np.searchsorted(dst_sorted, node_bounds, side="left").astype(np.int32),
        src_splits=np.searchsorted(src_sorted, node_bounds, side="left").astype(np.int32),
        rel_splits=rel_splits,
    )


@dataclasses.dataclass(frozen=True)
class EncodedGraph:
    """Fixed-shape encoding of one graph.

    Attributes:
        src, dst: ``[E_pad]`` int32 edge endpoints (padded entries point at 0).
        rel_ids: ``[E_pad]`` int32 relation id per edge into the unique set.
        edge_mask: ``[E_pad]`` float32; 1.0 for real edges, 0.0 for padding.
        char_ids: ``[U_pad, L]`` int32 tokenized unique relation texts.
        text_lengths: ``[U_pad]`` int32 true text lengths (padding rows → 1).
        num_nodes, num_edges, num_relations: true (unpadded) sizes.
        unique_texts: the deduplicated relation strings, first-occurrence order.
        rel_sorted: the edge arrays are stable-sorted by relation id.
        sort_plan: the layout's :class:`SortPlan`, when it was asked for.
        group_pad: non-zero when each relation's edge group is padded to a
            multiple of this many rows (single-relation tiles).
    """

    src: np.ndarray
    dst: np.ndarray
    rel_ids: np.ndarray
    edge_mask: np.ndarray
    char_ids: np.ndarray
    text_lengths: np.ndarray
    num_nodes: int
    num_edges: int
    num_relations: int
    unique_texts: Tuple[str, ...]
    rel_sorted: bool = False
    sort_plan: SortPlan | None = None
    group_pad: int = 0

    @property
    def arrays(self) -> tuple:
        """``(src, dst, rel_ids, edge_mask, char_ids, text_lengths)``."""
        return (
            self.src,
            self.dst,
            self.rel_ids,
            self.edge_mask,
            self.char_ids,
            self.text_lengths,
        )


def validate_graph_for_config(graph: EncodedGraph, config) -> None:
    """Refuse a graph whose layout breaks a promise the config makes.

    ``rel_sorted=True`` on unsorted edges, or the kernel backend on a layout
    that is not group-padded, would give wrong results silently; a plan
    built for another layout would index out of place.
    """
    if getattr(config, "rel_sorted", False) and not graph.rel_sorted:
        raise ValueError(
            "HyperGNNConfig(rel_sorted=True) requires a relation-sorted edge "
            "layout — build the graph with "
            "encode_graph(..., sort_by_relation=True)"
        )
    if getattr(config, "backend", None) in ("pallas", "pallas_packed", "cuda") or getattr(
        config, "group_padded", False
    ):
        if not graph.group_pad or graph.group_pad % GROUP_PAD:
            raise ValueError(
                "the cuda backend / group_padded=True requires the "
                "group-padded sorted edge layout with the kernel tile "
                "dividing the pad — build the graph with encode_graph(..., "
                f"sort_by_relation=True, group_pad={GROUP_PAD}) (got "
                f"group_pad={graph.group_pad}); merely-sorted edges would "
                "silently apply a tile's first relation to all its rows"
            )
    plan = graph.sort_plan
    if plan is not None and plan.dst_perm.shape != graph.dst.shape:
        raise ValueError(
            f"sort_plan was built for {plan.dst_perm.shape[0]} edges but the "
            f"graph stores {graph.dst.shape[0]} — rebuild with "
            "encode_graph(..., with_sort_plan=True)"
        )


def dedup_texts(edge_texts: Sequence[str]) -> Tuple[List[str], np.ndarray]:
    """Order-preserving dedup → (unique_texts, per-edge int32 relation ids)."""
    text_to_idx: dict = {}
    rel_ids = np.empty(len(edge_texts), dtype=np.int32)
    for i, t in enumerate(edge_texts):
        idx = text_to_idx.get(t)
        if idx is None:
            idx = len(text_to_idx)
            text_to_idx[t] = idx
        rel_ids[i] = idx
    return list(text_to_idx.keys()), rel_ids


def encode_graph(
    edge_index: np.ndarray,
    edge_texts: Sequence[str],
    num_nodes: int,
    *,
    pad: bool = True,
    sort_by_relation: bool = False,
    with_sort_plan: bool = False,
    group_pad: int = 0,
) -> EncodedGraph:
    """Build an :class:`EncodedGraph` from raw connectivity + relation strings.

    ``sort_by_relation=True`` stores the edges stable-sorted by relation id
    (aggregation is edge-order invariant). ``with_sort_plan=True`` adds the
    :class:`SortPlan`. ``group_pad=T`` (requires ``sort_by_relation``) pads
    each relation's edge group with masked rows carrying the group's
    relation id to a multiple of ``T``, so every ``T``-row tile holds one
    relation: the layout the edge transform kernel needs. It replaces the
    edge bucket padding.
    """
    edge_index = np.asarray(edge_index)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    e = edge_index.shape[1]
    if e != len(edge_texts):
        raise ValueError(
            f"edge_index has {e} edges but edge_texts has {len(edge_texts)} entries"
        )

    if group_pad and not sort_by_relation:
        raise ValueError("group_pad requires sort_by_relation=True")

    unique_texts, rel_ids = dedup_texts(edge_texts)
    u = len(unique_texts)
    char_ids, lengths = tokenize_texts(unique_texts)

    u_pad = pad_bucket_relations(u) if pad else max(u, 1)

    if group_pad:
        g = int(group_pad)
        counts = np.bincount(rel_ids, minlength=u_pad) if e else np.zeros(
            u_pad, dtype=np.int64
        )
        padded = ((counts + g - 1) // g) * g
        if padded.sum() == 0:
            # An empty graph still gets one all-masked tile.
            padded[u_pad - 1] = g
        offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
        e_pad = int(padded.sum())
        src = np.zeros(e_pad, dtype=np.int32)
        dst = np.zeros(e_pad, dtype=np.int32)
        mask = np.zeros(e_pad, dtype=np.float32)
        rids = np.repeat(np.arange(u_pad, dtype=np.int32), padded)
        if e:
            order = np.argsort(rel_ids, kind="stable")
            sorted_rel = rel_ids[order]
            group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(e) - group_start[sorted_rel]
            pos = offsets[sorted_rel] + within
            src[pos] = edge_index[0][order]
            dst[pos] = edge_index[1][order]
            mask[pos] = 1.0
    else:
        e_pad = pad_bucket_edges(e) if pad else max(e, 1)
        src = np.zeros(e_pad, dtype=np.int32)
        dst = np.zeros(e_pad, dtype=np.int32)
        rids = np.zeros(e_pad, dtype=np.int32)
        mask = np.zeros(e_pad, dtype=np.float32)
        src[:e] = edge_index[0]
        dst[:e] = edge_index[1]
        rids[:e] = rel_ids
        mask[:e] = 1.0
        if sort_by_relation:
            order = np.argsort(rids, kind="stable")
            src, dst, rids, mask = src[order], dst[order], rids[order], mask[order]

    cid = np.zeros((u_pad, char_ids.shape[1]), dtype=np.int32)
    lens = np.ones(u_pad, dtype=np.int32)  # padding rows behave like ""
    cid[:u] = char_ids
    lens[:u] = lengths

    plan = (
        build_sort_plan(src, dst, rids, mask, int(num_nodes), u_pad)
        if with_sort_plan
        else None
    )

    return EncodedGraph(
        src=src,
        dst=dst,
        rel_ids=rids,
        edge_mask=mask,
        char_ids=cid,
        text_lengths=lens,
        num_nodes=int(num_nodes),
        num_edges=e,
        num_relations=u,
        unique_texts=tuple(unique_texts),
        rel_sorted=sort_by_relation,
        sort_plan=plan,
        group_pad=int(group_pad),
    )
