"""Training objectives: the port of ``graph_hypernetwork_forge_tpu/training/objectives.py``.

The margin-ranking link-prediction loss of the reference training loop::

    loss = mean( max(0, margin - pos + neg) )

with positives scored on real edges and negatives on corrupted tails.
Padded edges are excluded through ``edge_mask`` (the mask-weighted mean
equals the plain mean over real edges).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from graph_hypernetwork_forge_tpu_torch.ops.scoring import (
    score_candidate_sets,
    score_pairs,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import sorted_segment_sum


def _masked_mean(per_edge: torch.Tensor, edge_mask: torch.Tensor | None) -> torch.Tensor:
    if edge_mask is None:
        return per_edge.mean()
    return (per_edge * edge_mask).sum() / edge_mask.sum().clamp(min=1.0)


def margin_ranking_loss(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    margin: float = 1.0,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    per_edge = (margin - pos_scores + neg_scores).clamp(min=0.0)
    return _masked_mean(per_edge, edge_mask)


def link_prediction_loss(
    embs: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    neg_dst: torch.Tensor,
    margin: float = 1.0,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Margin-ranking loss over (src→dst) positives vs (src→neg_dst) negatives."""
    pos = score_pairs(embs[src], embs[dst])
    neg = score_pairs(embs[src], embs[neg_dst])
    return margin_ranking_loss(pos, neg, margin=margin, edge_mask=edge_mask)


def multi_negative_loss(
    embs: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    neg_dst: torch.Tensor,
    margin: float = 1.0,
    edge_mask: torch.Tensor | None = None,
    adversarial_temperature: float = 0.0,
) -> torch.Tensor:
    """Margin-ranking loss averaged over K corrupted tails per positive.

    ``neg_dst [B, K]`` holds K negative tails per positive pair (K=1 is
    :func:`link_prediction_loss`). ``adversarial_temperature`` T > 0
    weights each negative's hinge by ``softmax(T * neg_score)`` over its K
    candidates, the weights detached from the graph (self-adversarial
    sampling); T = 0 is the uniform mean.
    """
    pos = score_pairs(embs[src], embs[dst])  # [B]
    neg = score_candidate_sets(embs, src, neg_dst)  # [B, K]
    hinge = (margin - pos[:, None] + neg).clamp(min=0.0)
    if adversarial_temperature > 0.0:
        w = torch.softmax(adversarial_temperature * neg.detach(), dim=1)
        per_pair = (w * hinge).sum(dim=1)
    else:
        per_pair = hinge.mean(dim=1)
    return _masked_mean(per_pair, edge_mask)


def _roll_index(e: int, shift: torch.Tensor, device) -> torch.Tensor:
    """``idx`` with ``x[idx] == torch.roll(x, -shift, 0)``: ``(i + shift) % E``.

    The shift stays a tensor (on the device in training), so rolling never
    reads it back to the host.
    """
    return (torch.arange(e, device=device) + shift) % e


class _LinkPredictionLossSorted(torch.autograd.Function):
    """Rolled-negative margin loss with the analytic backward of the JAX
    package's ``_lpl_fused_bwd`` (``training/objectives.py:135-186``)."""

    @staticmethod
    def forward(ctx, embs, src, dst, src_perm, src_sorted, src_splits, dst_perm,
                dst_sorted, dst_splits, roll_shift, edge_mask, margin):
        e = src.shape[0]
        shift = torch.as_tensor(roll_shift, device=embs.device).long()
        fwd = _roll_index(e, shift, embs.device)
        pos_h = embs.index_select(0, src)
        pos_t = embs.index_select(0, dst)
        neg_t = pos_t.index_select(0, fwd)
        hinge = margin - (pos_h * pos_t).sum(-1) + (pos_h * neg_t).sum(-1)
        denom = edge_mask.sum().clamp(min=1.0)
        loss = (hinge.clamp(min=0.0) * edge_mask).sum() / denom
        ctx.save_for_backward(
            pos_h, pos_t, src_perm, src_sorted, src_splits, dst_perm,
            dst_sorted, dst_splits, shift, edge_mask, hinge > 0.0, denom,
        )
        ctx.num_nodes, ctx.dtype = embs.shape[0], embs.dtype
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (pos_h, pos_t, src_perm, src_sorted, src_splits, dst_perm, dst_sorted,
         dst_splits, shift, edge_mask, active, denom) = ctx.saved_tensors
        e, dev = pos_h.shape[0], pos_h.device
        a = (g / denom * edge_mask * active)[:, None]  # [E, 1]
        # Stream 1 (src-sorted): dh_e = a_e · (t_{e+k} − t_e).
        t1 = a * (pos_t.index_select(0, _roll_index(e, shift, dev)) - pos_t)
        # Stream 2 (dst-sorted): dt_e = a_{e−k}·h_{e−k} − a_e·h_e.
        t2 = a * pos_h
        t3 = t2.index_select(0, _roll_index(e, -shift, dev)) - t2
        n = ctx.num_nodes
        stream_src = t1 if src_perm is None else t1.index_select(0, src_perm)
        stream_dst = t3 if dst_perm is None else t3.index_select(0, dst_perm)
        dembs = sorted_segment_sum(
            stream_src, src_sorted, n, src_splits
        ) + sorted_segment_sum(stream_dst, dst_sorted, n, dst_splits)
        # The reference gives edge_mask a ZERO cotangent, though the loss
        # depends on it (ROADMAP §3): kept as it is, flagged here.
        dmask = torch.zeros_like(edge_mask) if ctx.needs_input_grad[10] else None
        return (dembs.to(ctx.dtype),) + (None,) * 9 + (dmask, None)


def link_prediction_loss_sorted(
    embs: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    sort_plan,
    roll_shift,
    margin: float = 1.0,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sort-free margin-ranking loss over all positives.

    The objective of :func:`link_prediction_loss` with negatives formed by
    rotating the positive tails: ``neg_dst[i] = dst[(i + k) % E]`` for the
    step's one shift ``k = roll_shift`` (an int or a 0-d tensor). That is
    one member of the permutation family the reference draws negatives
    from, not uniform over all permutations: the pairs of a step share the
    shift. In exchange the backward needs no scatter: two cotangent streams
    formed from the saved gathers, each permuted into sorted order by the
    :class:`SortPlan` and reduced through the CSR segment-sum.

    With edge padding a rotated slot can land on a padded entry (tail =
    node 0); the positive-side ``edge_mask`` still governs which pairs
    enter the mean.
    """
    mask = (
        torch.ones(src.shape, dtype=embs.dtype, device=embs.device)
        if edge_mask is None else edge_mask
    )
    return _LinkPredictionLossSorted.apply(
        embs, src, dst,
        sort_plan.src_perm, sort_plan.src_sorted, sort_plan.src_splits,
        sort_plan.dst_perm, sort_plan.dst_sorted, sort_plan.dst_splits,
        roll_shift, mask, margin,
    )
