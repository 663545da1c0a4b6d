"""Relation-conditioned message passing: the HyperGNN compute core.

The port of ``graph_hypernetwork_forge_tpu/ops/message_passing.py``, with
the same semantics. For edge e = (u → v) with relation r::

    msg_e  = h_u @ W_msg[r] + bias[r]
    agg_v  = sum_{e → v} msg_e / max(cnt_v, 1)
    self_v = h_v @ (sum_{e → v} W_self[r_e] / max(cnt_v, 1))
    h'_v   = agg_v + self_v

so isolated nodes (cnt_v = 0) give exactly zero before the residual, and
masked padding edges add neither messages nor counts. Weights stay at
relation granularity ``[U, d, d]``.

Two backends:

``cuda``
    The kernel path, counterpart of the JAX package's ``pallas`` and
    ``pallas_packed``. On the relation-sorted, group-padded layout with a
    :class:`~graph_hypernetwork_forge_tpu_torch.data.encoding.SortPlan`, the
    edge transform kernel (``ops/cuda/edge_transform.py``) writes each
    edge's ``msg + self`` contribution and the CSR segment-sum kernel
    (``ops/cuda/segment_sum.py``) reduces them in dst order; one divide by
    the clamped count. On CPU tensors both run their plain versions. It is
    differentiable: the gathers, the transform and the tail are autograd
    Functions whose backwards run the fused backward kernel and reduce
    every cotangent through the CSR segment-sum, sort-free.

``gather``
    Per-edge weight gather and batched matvec: the parity oracle, with the
    two true divides of the JAX package, differentiated by PyTorch's own
    autograd (so it is the oracle for gradients too). It gathers
    ``[chunk, d, d]`` weights a chunk of edges at a time, so its forward's
    peak memory stays bounded; under autograd every chunk's gathered
    weights are kept for the backward.

The JAX package's ``dense``, ``grouped`` and ``chunked`` backends are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import (
    segment_sum,
    sorted_segment_sum_by_plan,
    take_rows_pair,
)

Backend = Literal[
    "auto", "cuda", "gather", "pallas", "pallas_packed", "dense", "grouped",
    "chunked",
]

# Edges per chunk of the gather oracle's [chunk, d, d] weight gather.
_GATHER_CHUNK = 1 << 16

_NOT_PORTED = ("dense", "grouped", "chunked")


def resolve_backend(
    backend: Backend, *, rel_sorted: bool, group_padded: bool,
    has_sort_plan: bool, platform: str,
) -> str:
    """The backend a config runs (pure: ``platform`` is injected).

    The JAX package's kernel backends ``pallas`` and ``pallas_packed`` are
    ``cuda`` here. ``auto`` picks ``cuda`` on the layout the kernels need
    (relation-sorted, group-padded, with a sort plan), at any width, on any
    ``platform``: on the CPU the kernels' plain versions run. Another
    layout under ``auto`` would need the unported ``grouped`` backend.
    """
    if backend in ("pallas", "pallas_packed", "cuda"):
        return "cuda"
    if backend == "auto":
        if rel_sorted and group_padded and has_sort_plan:
            return "cuda"
        raise NotImplementedError(
            f"backend='auto' on {platform} needs the relation-sorted, "
            "group-padded layout with a sort plan (encode_graph(..., "
            f"sort_by_relation=True, with_sort_plan=True, group_pad={GROUP_PAD})"
            " and HyperGNNConfig(rel_sorted=True, group_padded=True)); the "
            "grouped, dense and chunked backends for other layouts are not "
            "ported yet"
        )
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet; use 'cuda' on the "
            "group-padded layout or the 'gather' oracle"
        )
    if backend != "gather":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _check_cuda_layout(rel_sorted, group_padded, sort_plan) -> None:
    if not rel_sorted or not group_padded or sort_plan is None:
        raise ValueError(
            "backend='cuda' requires a rel-sorted GROUP_PAD-padded layout "
            "and a SortPlan (encode_graph(..., sort_by_relation=True, "
            f"with_sort_plan=True, group_pad={GROUP_PAD}))"
        )
    # A relation group that does not start on a 256-row boundary would make
    # a tile apply its first relation's weights to a second relation's
    # rows. encode_graph(group_pad=256) guarantees alignment; plans that
    # still hold host arrays are checked here, device tensors are not read
    # back.
    rs = sort_plan.rel_splits
    if isinstance(rs, torch.Tensor) and rs.device.type == "cpu":
        rs = rs.numpy()
    if isinstance(rs, np.ndarray) and (rs % GROUP_PAD).any():
        raise ValueError(
            "backend='cuda' needs relation groups padded to a "
            f"{GROUP_PAD}-edge multiple (encode_graph(group_pad={GROUP_PAD})); "
            "got rel_splits with boundaries not aligned"
        )


def _edge_contributions_gather(h, src, dst, rel_ids, w_msg, w_self, bias):
    """Per-edge ``(msg, self)`` via per-edge weight gather, chunk by chunk."""
    msg, self_c = [], []
    for lo in range(0, src.shape[0], _GATHER_CHUNK):
        s = slice(lo, lo + _GATHER_CHUNK)
        r = rel_ids[s]
        msg.append(
            torch.bmm(h[src[s]].unsqueeze(1), w_msg[r]).squeeze(1) + bias[r]
        )
        self_c.append(torch.bmm(h[dst[s]].unsqueeze(1), w_self[r]).squeeze(1))
    return torch.cat(msg), torch.cat(self_c)


def relational_message_passing(
    h: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_nodes: int | None = None,
    edge_mask: torch.Tensor | None = None,
    backend: Backend = "auto",
    rel_sorted: bool = False,
    sort_plan=None,
    group_padded: bool = False,
) -> torch.Tensor:
    """One round of relation-conditioned message passing → ``[N, d_out]`` f32.

    Args:
        h: ``[N, d_in]`` node embeddings.
        src, dst: ``[E]`` int32 edge endpoints (messages flow src → dst).
        rel_ids: ``[E]`` int32 relation id per edge.
        w_msg, w_self: ``[U, d_in, d_out]`` per-relation weights.
        bias: ``[U, d_out]`` per-relation bias.
        num_nodes: number of output nodes N (defaults to ``h.shape[0]``).
        edge_mask: optional ``[E]`` float mask; padded edges (0.0) add
            neither messages nor counts.
        backend: ``auto`` | ``cuda`` | ``gather`` (``pallas`` and
            ``pallas_packed`` mean ``cuda``).
        rel_sorted, group_padded: promises about the edge layout
            (``encode_graph(sort_by_relation=True, group_pad=256)``).
        sort_plan: the layout's SortPlan with tensors on ``h``'s device.

    Returns the pre-residual embeddings.
    """
    n = int(h.shape[0]) if num_nodes is None else num_nodes
    chosen = resolve_backend(
        backend, rel_sorted=rel_sorted, group_padded=group_padded,
        has_sort_plan=sort_plan is not None, platform=h.device.type,
    )

    if chosen == "cuda":
        _check_cuda_layout(rel_sorted, group_padded, sort_plan)
        plan = sort_plan
        x_src, x_dst = take_rows_pair(
            h, src, dst,
            plan.src_perm, plan.src_sorted, plan.src_splits,
            plan.dst_perm, plan.dst_sorted, plan.dst_splits,
        )
        contrib = edge_transform_sorted_combined(
            x_src, x_dst, rel_ids, w_msg, w_self, bias, plan.rel_splits
        )
        cnt = plan.in_degree[:n].clamp(min=1.0)[:, None]
        if edge_mask is not None:
            contrib = contrib * edge_mask[:, None]
        total = sorted_segment_sum_by_plan(
            contrib, plan.dst_perm, plan.inv_dst_perm, plan.dst_sorted, n,
            plan.dst_splits,
        )
        return total / cnt

    # The oracle reads no sort plan and runs no kernel: counts and sums
    # come from index_add_ over dst in the stored edge order.
    msg, self_contrib = _edge_contributions_gather(
        h, src, dst, rel_ids, w_msg, w_self, bias
    )
    if edge_mask is None:
        edge_mask = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    cnt = segment_sum(edge_mask, dst, n).clamp(min=1.0)[:, None]
    d_out = msg.shape[-1]
    both = torch.cat([msg, self_contrib], dim=-1) * edge_mask[:, None]
    total = segment_sum(both, dst, n)
    # Two true divides, as the JAX package's oracle rounds them.
    return total[:, :d_out] / cnt + total[:, d_out:] / cnt
