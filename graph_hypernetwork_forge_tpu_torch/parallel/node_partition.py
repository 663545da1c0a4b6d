"""Node-partitioned message passing: owner-computes aggregation and a gather
of h.

The port of ``graph_hypernetwork_forge_tpu/parallel/node_partition.py``.
Nodes are range-sharded over the mesh axis; each rank owns the aggregation
of its node range, and the edges are partitioned by dst owner on the host
(:func:`partition_edges_by_dst`), so no segment sum crosses ranks. What
crosses is the source rows of boundary edges; this v1 gathers the whole h
(``parallel/halo.py`` moves only the boundary rows). Each dst's in-edges
all live on its owner, so the mean (count clamp and all) is the
single-process one per node.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    _edge_contributions_dense,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    copy,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import check_precision
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple


def partition_edges_by_dst(
    src: np.ndarray,
    dst: np.ndarray,
    rel_ids: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    num_shards: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Group edges by dst owner into equal-size padded shards.

    Returns ``(src', dst', rel', mask', nodes_per_shard)``, each array
    ``[num_shards * cap]`` and shard-major, in the input dtypes; padded
    entries have mask 0 and point at the owner's first node (in range for
    the local segment sum).
    """
    nodes_per_shard = round_up_to_multiple(-(-num_nodes // num_shards), 1)
    real = edge_mask > 0
    owner = np.minimum(dst // nodes_per_shard, num_shards - 1)
    owner = np.where(real, owner, -1)

    counts = np.bincount(owner[real], minlength=num_shards)
    cap = round_up_to_multiple(int(counts.max()) if counts.size else 1, 8)

    out_src = np.zeros(num_shards * cap, dtype=src.dtype)
    out_dst = np.zeros(num_shards * cap, dtype=dst.dtype)
    out_rel = np.zeros(num_shards * cap, dtype=rel_ids.dtype)
    out_mask = np.zeros(num_shards * cap, dtype=edge_mask.dtype)
    for s in range(num_shards):
        sel = np.nonzero(owner == s)[0]
        base = s * cap
        out_src[base : base + sel.size] = src[sel]
        out_dst[base : base + sel.size] = dst[sel]
        out_rel[base : base + sel.size] = rel_ids[sel]
        out_mask[base : base + sel.size] = 1.0
        out_dst[base + sel.size : base + cap] = min(
            s * nodes_per_shard, num_nodes - 1
        )
    return out_src, out_dst, out_rel, out_mask, nodes_per_shard


def node_partitioned_message_passing(
    mesh: DeviceMesh,
    h: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    edge_mask: torch.Tensor,
    nodes_per_shard: int,
    *,
    axis: str = "edge",
    precision="highest",
) -> torch.Tensor:
    """Owner-computes message passing over dst-partitioned edges.

    ``h`` is this rank's ``[nodes_per_shard, d]`` range of the node rows;
    ``src``, ``dst`` (global ids), ``rel_ids`` and ``edge_mask`` are its
    block of :func:`partition_edges_by_dst`'s arrays; the banks and the
    bias are whole. Returns this rank's ``[nodes_per_shard, d_out]`` rows.
    """
    check_precision(precision)
    h_full = copy(all_gather(h, mesh, axis), mesh, axis)
    w_msg, w_self, bias = (copy(t, mesh, axis) for t in (w_msg, w_self, bias))
    msg, self_c = _edge_contributions_dense(h_full, src, dst, rel_ids, w_msg, w_self, bias)
    local_dst = dst - axis_index(mesh, axis) * nodes_per_shard
    return two_stream_tail(msg, self_c, local_dst, nodes_per_shard, edge_mask=edge_mask)
