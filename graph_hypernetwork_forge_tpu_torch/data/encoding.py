"""Host-side graph encoding: raw (edge_index, edge_texts) → padded arrays.

The same encoding as the JAX package (``graph_hypernetwork_forge_tpu/data/
encoding.py``), array for array: relation dedup in first-occurrence order,
char tokenization, edge and relation padding to buckets, the optional
relation-sorted and group-padded layouts, and the :class:`SortPlan` of
host-precomputed permutations and CSR bounds. Relation identity enters the
model only through the tokenized text.

Everything here is numpy, with the native C++ extension (``native_bridge``)
for the dedup, the tokenizer and the stable counting sorts where it is
built, as the JAX encoder uses it; every array is the same either way.
:meth:`SortPlan.to` moves a plan's arrays to a torch device for the
compute core.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch import native_bridge
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count, enabled, span
from graph_hypernetwork_forge_tpu_torch.utils.shapes import (
    pad_bucket_edges,
    pad_bucket_relations,
)
from graph_hypernetwork_forge_tpu_torch.utils.text import tokenize_texts

# Rows per single-relation tile of the group-padded layout; the edge
# transform kernel's tile (``ops/cuda/edge_transform.py``).
GROUP_PAD = 256
# Tiles of one relation that one block walks in kernel 3 (the combined
# transform's backward, ``ops/cuda/edge_transform_bwd.py``) and in kernel 6
# (``ops/cuda/segment_outer.py``): the run length of the run table that a
# SortPlan carries for both. Runs of 4 were the fastest of 1, 2, 4 and 8
# tiles for kernel 3 in every form and for kernel 6 in 5 of its 6 forms and
# widths on the H100 (scripts/tune_edge_kernels.py).
RUN_TILES = 4


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """Host-precomputed sort permutations and CSR bounds of one edge layout.

    All arrays are ``[E_pad]`` except ``in_degree`` (``[N]`` float32 masked
    in-edge count), ``rel_counts`` (``[U_pad]`` int32 edges per relation,
    masked padding edges included) and the ``*_splits`` CSR row bounds
    (``splits[i]`` = first row whose sorted id is ``>= i``; ``[N + 1]`` or
    ``[U_pad + 1]``). ``rel_splits`` describes the stored layout only when
    that layout is relation-sorted, and so does the run table of kernels 3
    and 6 built from it once per layout: ``tile_splits`` (``[U_pad + 1]``,
    relation u's 256-row tiles, ``ceil(rel_splits / 256)``) and
    ``run_splits`` (:func:`split_runs` of them into runs of ``RUN_TILES``
    tiles). It goes to the kernels as it is, with no launch to build it per
    call.

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
    tile_splits: np.ndarray | None = None
    run_splits: np.ndarray | None = None

    def to(self, device) -> "SortPlan":
        """The same plan with every array a torch tensor on ``device``
        (dtypes kept: int32 ids and bounds, float32 degrees).

        One ``torch.as_tensor`` copy per array, from pageable host memory:
        the ``nbytes`` of every array, 24 bytes a layout row (six int32
        arrays), 12 a node (the degree and two CSR bounds) and 16 a padded
        relation, which the ``to_device_bytes`` counter adds while recording.
        """
        if enabled():
            count("to_device_bytes", sum(
                a.nbytes for f in dataclasses.fields(self)
                if (a := getattr(self, f.name)) is not None))
        return SortPlan(**{
            f.name: None if (a := getattr(self, f.name)) is None
            else torch.as_tensor(a, device=device)
            for f in dataclasses.fields(self)
        })


def split_runs(tile_splits: np.ndarray, run_tiles: int) -> np.ndarray:
    """``[U + 1]`` int32 run bounds: relation u's tiles ``[tile_splits[u],
    tile_splits[u + 1])`` go in runs of ``run_tiles`` from the first, the
    last one ragged, numbered ``run_splits[u] .. run_splits[u + 1] - 1``."""
    runs = -(-np.diff(tile_splits) // run_tiles)
    out = np.zeros(tile_splits.shape[0], dtype=np.int32)
    np.cumsum(runs, out=out[1:])
    return out


def _node_sort(ids: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(perm, splits)``: the stable argsort of node ids in ``[0,
    num_nodes)`` and the CSR bounds of the sorted ids (``splits[i]`` = first
    row whose sorted id is ``>= i``), both int32. Natively one counting
    sort (``build_csr``), else ``np.argsort`` and a binary search."""
    native = native_bridge.get_native()
    # The counting sort indexes by id: ids outside [0, num_nodes) (a
    # partition's pad rows can carry them) take the comparison sort.
    in_range = ids.size == 0 or (ids.min() >= 0 and ids.max() < num_nodes)
    if native is not None and in_range:
        ptr, perm = native.build_csr(ids, num_nodes)
        return perm.astype(np.int32), ptr.astype(np.int32)
    perm = np.argsort(ids, kind="stable")
    splits = np.searchsorted(ids[perm], np.arange(num_nodes + 1), side="left")
    return perm.astype(np.int32), splits.astype(np.int32)


def relation_order(rel_ids: np.ndarray, num_rel: int) -> np.ndarray:
    """The stable argsort of relation ids in ``[0, num_rel)``: natively a
    counting sort (``sort_by_relation``), else ``np.argsort``."""
    native = native_bridge.get_native()
    if native is not None:
        return native.sort_by_relation(rel_ids, num_rel)
    return np.argsort(rel_ids, kind="stable")


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

    dst_perm, dst_splits = _node_sort(dst, num_nodes)
    inv_dst = np.empty(e, dtype=np.int32)
    inv_dst[dst_perm] = arange
    src_perm, src_splits = _node_sort(src, num_nodes)
    inv_src = np.empty(e, dtype=np.int32)
    inv_src[src_perm] = arange

    # Masked padding edges point at node 0 and add 0 to its degree.
    in_degree = np.zeros(num_nodes, dtype=np.float32)
    np.add.at(in_degree, dst, edge_mask.astype(np.float32))

    rel_counts = np.bincount(rel_ids, minlength=num_rel_pad).astype(np.int32)

    dst_sorted = dst[dst_perm].astype(np.int32)
    src_sorted = src[src_perm].astype(np.int32)
    rel_splits = np.zeros(num_rel_pad + 1, dtype=np.int32)
    np.cumsum(rel_counts, out=rel_splits[1:])
    # Tile t takes the relation of its first row 256 t, so the tiles below
    # relation u are those with 256 t < rel_splits[u].
    tile_splits = (-(-rel_splits // GROUP_PAD)).astype(np.int32)

    return SortPlan(
        dst_perm=dst_perm,
        inv_dst_perm=inv_dst,
        dst_sorted=dst_sorted,
        src_perm=src_perm,
        inv_src_perm=inv_src,
        src_sorted=src_sorted,
        in_degree=in_degree,
        rel_counts=rel_counts,
        dst_splits=dst_splits,
        src_splits=src_splits,
        rel_splits=rel_splits,
        tile_splits=tile_splits,
        run_splits=split_runs(tile_splits, RUN_TILES),
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
    """Order-preserving dedup → (unique_texts, per-edge int32 relation ids).

    Natively one C++ hash pass, except for an ``np.ndarray`` of texts, as
    the JAX encoder skips it there.
    """
    native = native_bridge.get_native()
    if native is not None and not isinstance(edge_texts, np.ndarray):
        return native.dedup_and_ids(list(edge_texts))
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

    It is span ``encode``, whose stages ``encode.dedup``, ``encode.tokenize``,
    ``encode.layout`` and ``encode.sort_plan`` partition its work
    (``utils/profiling.py``).
    """
    with span("encode"):
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

        with span("encode.dedup"):
            unique_texts, rel_ids = dedup_texts(edge_texts)
            u = len(unique_texts)
        with span("encode.tokenize"):
            char_ids, lengths = tokenize_texts(unique_texts)

        with span("encode.layout"):
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
                    order = relation_order(rel_ids, u_pad)
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
                    order = relation_order(rids, u_pad)
                    src, dst, rids, mask = src[order], dst[order], rids[order], mask[order]

            cid = np.zeros((u_pad, char_ids.shape[1]), dtype=np.int32)
            lens = np.ones(u_pad, dtype=np.int32)  # padding rows behave like ""
            cid[:u] = char_ids
            lens[:u] = lengths

        plan = None
        if with_sort_plan:
            with span("encode.sort_plan"):
                plan = build_sort_plan(src, dst, rids, mask, int(num_nodes), u_pad)

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
