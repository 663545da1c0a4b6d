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

Backends:

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

``dense``
    One ``[2U]``-batched product ``HW[u] = H @ W[u]`` over both banks, then
    per-edge row gathers: O(U·N·d²) operations, for relation-dense graphs.

``grouped``
    Edges grouped by relation (the stored order when ``rel_sorted``, else a
    stable argsort and its inverse), one ``[rows, d_in] @ [d_in, d_out]``
    product per relation group: O(E·d²). The group sizes are read to the
    host once per call. With a SortPlan on the sorted layout the gathers
    and the bias reduce their cotangents sort-free through kernel 1.

``chunked``
    Streams the edges 32,768 at a time through per-edge weight gathers into
    f32 accumulators, and re-streams them in its backward: peak memory
    O(chunk·d²) + O(N·d) at any E.

``gather``
    Per-edge weight gather and batched matvec: the parity oracle,
    differentiated by PyTorch's own autograd (so it is the oracle for
    gradients too). It gathers ``[chunk, d, d]`` weights a chunk of edges
    at a time, so its forward's peak memory stays bounded; under autograd
    every chunk's gathered weights are kept for the backward. It reads no
    sort plan and runs no kernel.

``dense``, ``grouped`` and ``gather`` feed the two-stream tail
(:func:`two_stream_tail`): ``(msg, self)`` reduced over dst in one fused
``[E, 2d]`` segment-sum (two above a budget), divided by the count twice.
``auto`` picks ``cuda`` on the kernel layout and otherwise as the JAX
package's ``_pick_backend`` does. Products run in full float32: the port's
entry points turn TF32 off when they choose the card
(``device.resolve_device``).
"""

from __future__ import annotations

from typing import Literal, get_args

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import (
    segment_count,
    segment_sum,
    sorted_segment_sum_by_plan,
    take_rows_pair,
    take_rows_sorted,
)

Backend = Literal[
    "auto", "cuda", "gather", "pallas", "pallas_packed", "dense", "grouped",
    "chunked",
]

# Edges per chunk of the gather oracle's [chunk, d, d] weight gather.
_GATHER_CHUNK = 1 << 16

# Edges per chunk of the chunked backend (the JAX package's 32,768).
_STREAM_CHUNK = 32_768

# The JAX package's budgets, in floats: the dense backend's [U, N, d]
# product; the grouped backend's [E, d] buffers, beyond which the chunked
# path bounds peak memory; and the [E, d] size above which the tail runs
# two [E, d] reductions instead of one fused [E, 2d] one.
_DENSE_BUDGET_ELEMENTS = 1 << 30
_GROUPED_BUDGET_ELEMENTS = 1 << 28
_FUSED_TAIL_BUDGET_ELEMENTS = 1 << 28



def _pick_backend(
    backend: Backend, num_nodes: int, num_rel: int, num_edges: int,
    d_out: int, rel_sorted: bool = False,
) -> str:
    """The JAX package's regime pick for ``auto``, rule for rule: ``dense``
    (O(U·N·d²) operations, a ``[2U, N, d]`` product) only on unsorted
    layouts whose relations are dense; ``grouped`` (O(E·d²)) on sorted
    layouts and sparse ones; ``chunked`` when neither fits its budget."""
    if backend != "auto":
        return backend
    if num_edges * d_out > _GROUPED_BUDGET_ELEMENTS:
        if num_rel * num_nodes * d_out <= _DENSE_BUDGET_ELEMENTS:
            return "dense"
        return "chunked"
    if rel_sorted:
        return "grouped"
    if num_rel * num_nodes * d_out > _DENSE_BUDGET_ELEMENTS:
        return "grouped"
    if num_rel * num_nodes > 8 * num_edges:
        return "grouped"
    return "dense"


def resolve_backend(
    backend: Backend, num_nodes: int, num_rel: int, num_edges: int,
    d_out: int, *, rel_sorted: bool, group_padded: bool, has_sort_plan: bool,
) -> str:
    """The backend a config runs (pure).

    The JAX package's kernel backends ``pallas`` and ``pallas_packed`` are
    ``cuda`` here. ``auto`` picks ``cuda`` on the layout the kernels need
    (relation-sorted, group-padded, with a sort plan), at any size and on
    any device (on the CPU the kernels' plain versions run); on any other
    layout it picks as :func:`_pick_backend`. The other backends run as
    asked.
    """
    if backend not in get_args(Backend):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("pallas", "pallas_packed", "cuda"):
        return "cuda"
    if backend == "auto" and rel_sorted and group_padded and has_sort_plan:
        return "cuda"
    return _pick_backend(
        backend, num_nodes, num_rel, num_edges, d_out, rel_sorted=rel_sorted
    )


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


def _gather_chunk(h, src, dst, rel_ids, w_msg, w_self, bias):
    """``(msg, self)`` of one chunk of edges via per-edge weight gather."""
    msg = torch.bmm(h[src].unsqueeze(1), w_msg[rel_ids]).squeeze(1) + bias[rel_ids]
    self_c = torch.bmm(h[dst].unsqueeze(1), w_self[rel_ids]).squeeze(1)
    return msg, self_c


def _edge_contributions_gather(h, src, dst, rel_ids, w_msg, w_self, bias):
    """Per-edge ``(msg, self)`` via per-edge weight gather, chunk by chunk."""
    parts = [
        _gather_chunk(h, src[s], dst[s], rel_ids[s], w_msg, w_self, bias)
        for s in (slice(lo, lo + _GATHER_CHUNK)
                  for lo in range(0, src.shape[0], _GATHER_CHUNK))
    ]
    return torch.cat([m for m, _ in parts]), torch.cat([c for _, c in parts])


def _edge_contributions_dense(h, src, dst, rel_ids, w_msg, w_self, bias):
    """Per-edge ``(msg, self)`` from the all-relations product: one
    ``[2U]``-batched ``HW[u] = H @ W[u]`` over both banks, then each edge
    gathers one row of it instead of one ``[d, d]`` weight."""
    u = w_msg.shape[0]
    hw = torch.matmul(h, torch.cat([w_msg, w_self]))  # [2U, N, d_out]
    rel, src, dst = rel_ids.long(), src.long(), dst.long()
    return hw[rel, src] + bias[rel], hw[rel + u, dst]


def _group_bounds(sizes):
    """``(group, lo, hi)`` row bounds of the non-empty groups of ``sizes``."""
    lo = 0
    for i, size in enumerate(sizes):
        if size:
            yield i, lo, lo + size
        lo += size


def _ragged_dot(x, w, sizes):
    """``out[e] = x[e] @ w[g(e)]`` for rows grouped in order by ``sizes``
    (a host list): one product per non-empty group, written in place; rows
    past the groups are 0, as in ``jax.lax.ragged_dot``."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    out[sum(sizes):].zero_()
    for i, lo, hi in _group_bounds(sizes):
        torch.mm(x[lo:hi], w[i], out=out[lo:hi])
    return out


class _RaggedTransform(torch.autograd.Function):
    """:func:`_ragged_dot` with the JAX package's VJP (``_ragged_transform``,
    its ``ops/message_passing.py:260-301``): ``dx`` the same product against
    the transposed weights, ``dw[g]`` the group's ``xᵀ g``, 0 for an empty
    group."""

    @staticmethod
    def forward(ctx, x, w, sizes):
        ctx.save_for_backward(x, w)
        ctx.sizes = sizes
        return _ragged_dot(x, w, sizes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _ragged_dot(g, w.transpose(1, 2), ctx.sizes)
        dw = torch.zeros_like(w)
        for i, lo, hi in _group_bounds(ctx.sizes):
            torch.mm(x[lo:hi].transpose(0, 1), g[lo:hi], out=dw[i])
        return dx, dw, None


def _edge_contributions_grouped(h, src, dst, rel_ids, w_msg, w_self, bias,
                                rel_sorted=False, sort_plan=None):
    """Per-edge ``(msg, self)`` via one product per relation group.

    With a SortPlan on the sorted layout the group sizes come from the plan
    and every gather reduces its cotangent through the plan (kernel 1);
    on the sorted layout without one, plain gathers; on an unsorted layout,
    a stable argsort into groups and the inverse permutation back.
    """
    u = w_msg.shape[0]
    if sort_plan is not None and rel_sorted:
        p = sort_plan
        sizes = p.rel_counts[:u].tolist()
        h_src, h_dst = take_rows_pair(
            h, src, dst, p.src_perm, p.src_sorted, p.src_splits,
            p.dst_perm, p.dst_sorted, p.dst_splits,
        )
        # rel_ids are non-decreasing here: the bias cotangent needs no
        # permute before its reduction.
        bias_e = take_rows_sorted(bias, rel_ids, None, rel_ids, p.rel_splits)
        msg = _RaggedTransform.apply(h_src, w_msg, sizes) + bias_e
        return msg, _RaggedTransform.apply(h_dst, w_self, sizes)
    sizes = torch.bincount(rel_ids, minlength=u)[:u].tolist()
    if rel_sorted:
        msg = (
            _RaggedTransform.apply(h.index_select(0, src), w_msg, sizes)
            + bias.index_select(0, rel_ids)
        )
        return msg, _RaggedTransform.apply(h.index_select(0, dst), w_self, sizes)
    order = torch.argsort(rel_ids, stable=True)
    msg_s = (
        _RaggedTransform.apply(h.index_select(0, src[order]), w_msg, sizes)
        + bias.index_select(0, rel_ids[order])
    )
    self_s = _RaggedTransform.apply(h.index_select(0, dst[order]), w_self, sizes)
    # Back to the caller's edge order through the inverse permutation.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return msg_s[inv], self_s[inv]


class _MpChunked(torch.autograd.Function):
    """The JAX package's ``_mp_chunked`` (its ``ops/message_passing.py:
    111-240``): forward and backward stream the edges chunk by chunk into
    f32 accumulators, so neither keeps any chunk's ``[chunk, d, d]``
    gathered weights; the backward recomputes them."""

    @staticmethod
    def forward(ctx, h, w_msg, w_self, bias, src, dst, rel_ids, mask, n, chunk):
        d_out = w_msg.shape[-1]
        # f32 accumulators (f64 for f64 inputs, as in the gradient checks).
        acc = dict(dtype=torch.promote_types(h.dtype, torch.float32), device=h.device)
        agg, selft = torch.zeros((n, d_out), **acc), torch.zeros((n, d_out), **acc)
        cnt = torch.zeros((n,), **acc)
        for lo in range(0, src.shape[0], chunk):
            s = slice(lo, lo + chunk)
            msg, self_c = _gather_chunk(h, src[s], dst[s], rel_ids[s], w_msg, w_self, bias)
            m = mask[s]
            agg.index_add_(0, dst[s], msg * m[:, None])
            selft.index_add_(0, dst[s], self_c * m[:, None])
            cnt.index_add_(0, dst[s], m)
        cnt = cnt.clamp(min=1.0)
        ctx.save_for_backward(h, w_msg, w_self, src, dst, rel_ids, mask, cnt)
        ctx.chunk = chunk
        return (agg + selft) / cnt[:, None]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, w_msg, w_self, src, dst, rel_ids, mask, cnt = ctx.saved_tensors
        g_over_cnt = g / cnt[:, None]
        dh = torch.zeros_like(h)
        dw_msg, dw_self = torch.zeros_like(w_msg), torch.zeros_like(w_self)
        dbias = g.new_zeros((w_msg.shape[0], w_msg.shape[2]))
        for lo in range(0, src.shape[0], ctx.chunk):
            s = slice(lo, lo + ctx.chunk)
            src_c, dst_c, rel_c = src[s], dst[s], rel_ids[s]
            ge = g_over_cnt[dst_c] * mask[s][:, None]  # [chunk, d_out]
            dh.index_add_(0, src_c, torch.einsum("eo,edo->ed", ge, w_msg[rel_c]))
            dh.index_add_(0, dst_c, torch.einsum("eo,edo->ed", ge, w_self[rel_c]))
            dw_msg.index_add_(0, rel_c, torch.einsum("ed,eo->edo", h[src_c], ge))
            dw_self.index_add_(0, rel_c, torch.einsum("ed,eo->edo", h[dst_c], ge))
            dbias.index_add_(0, rel_c, ge)
        return (dh, dw_msg, dw_self, dbias) + (None,) * 6


def _reduce_dst(x, dst, n, sort_plan):
    if sort_plan is not None:
        p = sort_plan
        return sorted_segment_sum_by_plan(
            x, p.dst_perm, p.inv_dst_perm, p.dst_sorted, n, p.dst_splits
        )
    return segment_sum(x, dst, n)


def two_stream_tail(
    msg: torch.Tensor,
    self_contrib: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    *,
    edge_mask: torch.Tensor | None = None,
    sort_plan=None,
) -> torch.Tensor:
    """The aggregation tail of ``(msg, self)`` streams → ``[N, d_out]``.

    The JAX package's tail (its ``ops/message_passing.py:700-753``): counts
    from the plan's ``in_degree``, else from the mask over ``dst``; one
    fused ``[E, 2d]`` segment-sum over dst (in dst-sorted order through the
    plan and kernel 1 when there is a plan, else ``index_add_``), or two
    ``[E, d]`` ones above ``_FUSED_TAIL_BUDGET_ELEMENTS``; then two true
    divides, ``agg / cnt + self / cnt``, as the reference rounds them.
    """
    n = num_nodes
    if sort_plan is not None:
        cnt = sort_plan.in_degree[:n].clamp(min=1.0)[:, None]
    else:
        cnt = segment_count(dst, n, edge_mask).clamp(min=1.0)[:, None]
    if msg.numel() > _FUSED_TAIL_BUDGET_ELEMENTS:
        if edge_mask is not None:
            msg = msg * edge_mask[:, None]
            self_contrib = self_contrib * edge_mask[:, None]
        total_msg = _reduce_dst(msg, dst, n, sort_plan)
        total_self = _reduce_dst(self_contrib, dst, n, sort_plan)
        return total_msg / cnt + total_self / cnt
    d_out = msg.shape[-1]
    both = torch.cat([msg, self_contrib], dim=-1)
    if edge_mask is not None:
        both = both * edge_mask[:, None]
    total = _reduce_dst(both, dst, n, sort_plan)
    return total[:, :d_out] / cnt + total[:, d_out:] / cnt


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
        backend: ``auto`` | ``cuda`` | ``dense`` | ``grouped`` |
            ``chunked`` | ``gather`` (``pallas`` and ``pallas_packed``
            mean ``cuda``).
        rel_sorted, group_padded: promises about the edge layout
            (``encode_graph(sort_by_relation=True[, group_pad=256])``);
            wrong results follow if the layout is otherwise.
        sort_plan: the layout's SortPlan with tensors on ``h``'s device.

    Returns the pre-residual embeddings.
    """
    n = int(h.shape[0]) if num_nodes is None else num_nodes
    chosen = resolve_backend(
        backend, n, int(w_msg.shape[0]), int(src.shape[0]), int(w_msg.shape[2]),
        rel_sorted=rel_sorted, group_padded=group_padded,
        has_sort_plan=sort_plan is not None,
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

    if chosen == "chunked":
        if edge_mask is None:
            edge_mask = torch.ones(src.shape, dtype=torch.float32, device=src.device)
        return _MpChunked.apply(
            h, w_msg, w_self, bias, src, dst, rel_ids, edge_mask, n, _STREAM_CHUNK
        )
    if chosen == "dense":
        msg, self_c = _edge_contributions_dense(h, src, dst, rel_ids, w_msg, w_self, bias)
    elif chosen == "grouped":
        msg, self_c = _edge_contributions_grouped(
            h, src, dst, rel_ids, w_msg, w_self, bias,
            rel_sorted=rel_sorted, sort_plan=sort_plan,
        )
    else:
        # The oracle reads no sort plan and runs no kernel: counts and sums
        # come from index_add_ over dst in the stored edge order.
        msg, self_c = _edge_contributions_gather(h, src, dst, rel_ids, w_msg, w_self, bias)
        sort_plan = None
    return two_stream_tail(
        msg, self_c, dst, n, edge_mask=edge_mask, sort_plan=sort_plan
    )
