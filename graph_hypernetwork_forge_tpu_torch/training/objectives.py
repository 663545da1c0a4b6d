"""Training objectives: the port of ``graph_hypernetwork_forge_tpu/training/objectives.py``.

The margin-ranking link-prediction loss of the reference training loop::

    loss = mean( max(0, margin - pos + neg) )

with positives scored on real edges and negatives on corrupted tails.
Padded edges are excluded through ``edge_mask`` (the mask-weighted mean
equals the plain mean over real edges). While spans record, each loss adds
the least bytes of its row gathers, forward and backward, to the
``gather_bytes`` counter (``ops/segment.py`` :func:`count_gather`), and one
to the count of its kind: ``loss_sorted_uniform`` for
:func:`link_prediction_loss`, whose backward sums through kernel 1 in
sorted order, ``loss_plain`` for :func:`multi_negative_loss`, whose
gathers PyTorch's index backward sums. The two sorted losses take their
rows, forward and backward, through the gather kernel
(``ops/cuda/gather_rows.py``; ``index_select`` on the CPU).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows import gather_rows
from graph_hypernetwork_forge_tpu_torch.ops.scoring import (
    score_candidate_sets,
    score_pairs,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import (
    count_gather,
    reduce_unsorted,
    sorted_segment_sum,
)
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count


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


# The steps the sorted losses share.


def _mask_or_ones(edge_mask, src, embs):
    if edge_mask is not None:
        return edge_mask
    return torch.ones(src.shape, dtype=embs.dtype, device=embs.device)


def _hinge_mean(ctx, embs, h, t, n, edge_mask, margin, saved) -> torch.Tensor:
    """The mask-weighted mean of ``max(0, margin − ⟨h,t⟩ + ⟨h,n⟩)``, as
    :func:`margin_ranking_loss` gives it. Saves ``saved``, then what
    :func:`_hinge_weights` reads."""
    hinge = margin - score_pairs(h, t) + score_pairs(h, n)
    denom = edge_mask.sum().clamp(min=1.0)
    ctx.save_for_backward(*saved, edge_mask, hinge > 0.0, denom)
    ctx.num_nodes, ctx.dtype = embs.shape[0], embs.dtype
    return (hinge.clamp(min=0.0) * edge_mask).sum() / denom


def _hinge_weights(ctx, g):
    """``(saved, a [E, 1], edge_mask)``: the tensors :func:`_hinge_mean`
    was given to save, and each edge's weight in the backward,
    ``a = g / denom · mask · (hinge > 0)``."""
    *saved, edge_mask, active, denom = ctx.saved_tensors
    return saved, (g / denom * edge_mask * active)[:, None], edge_mask


def _mask_cotangent(ctx, edge_mask, index):
    # The reference gives edge_mask a ZERO cotangent, though the loss
    # depends on it (ROADMAP §3): kept as it is, flagged here.
    return torch.zeros_like(edge_mask) if ctx.needs_input_grad[index] else None


class _LinkPredictionLossUniformSorted(torch.autograd.Function):
    """Uniform-negative margin loss (K = 1) whose backward sums its three
    cotangent streams as one sorted stream through kernel 1: no scatter."""

    @staticmethod
    def forward(ctx, embs, src, dst, neg_dst, edge_mask, margin):
        h, t, n = gather_rows(embs, src, dst, neg_dst)
        for idx in (src, dst, neg_dst):
            count_gather(embs, idx)
        return _hinge_mean(ctx, embs, h, t, n, edge_mask, margin, (h, t, n, src, dst, neg_dst))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (h, t, n, src, dst, neg_dst), a, edge_mask = _hinge_weights(ctx, g)
        # dh_e = a_e·(n_e − t_e) keyed by src, dt_e = −a_e·h_e by dst and
        # dn_e = a_e·h_e by neg_dst: 3E rows, summed in one pass.
        ah = a * h
        dembs = reduce_unsorted(torch.cat([a * (n - t), -ah, ah]),
                                torch.cat([src, dst, neg_dst]), ctx.num_nodes)
        return dembs.to(ctx.dtype), None, None, None, _mask_cotangent(ctx, edge_mask, 4), None


def link_prediction_loss(
    embs: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    neg_dst: torch.Tensor,
    margin: float = 1.0,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Margin-ranking loss over (src→dst) positives vs (src→neg_dst) negatives.

    The forward gathers ``embs[src]``, ``embs[dst]`` and ``embs[neg_dst]``
    once each, in one launch of the gather kernel on the card. The backward puts the three cotangent streams, keyed by
    ``src``, ``dst`` and ``neg_dst``, in one stable sort on their device (no
    host read) and sums each node's rows with kernel 1 in that order: no
    scatter, bitwise deterministic, and a node that many rows name, such as
    node 0 under a group-padded layout's pad rows, costs no more than its
    rows. Every caller hands it plain tensors: the sharded step gathers its
    sharded arrays at its entry.
    """
    count("loss_sorted_uniform", 1)
    return _LinkPredictionLossUniformSorted.apply(
        embs, src, dst, neg_dst, _mask_or_ones(edge_mask, src, embs), margin,
    )


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
    count("loss_plain", 1)
    for idx in (src, dst, src, neg_dst):
        count_gather(embs, idx, plain=True)
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
        pos_h, pos_t = gather_rows(embs, src, dst)
        (neg_t,) = gather_rows(pos_t, fwd)
        for table, idx in ((embs, src), (embs, dst), (pos_t, fwd)):
            count_gather(table, idx)
        return _hinge_mean(ctx, embs, pos_h, pos_t, neg_t, edge_mask, margin, (
            pos_h, pos_t, src_perm, src_sorted, src_splits, dst_perm, dst_sorted,
            dst_splits, shift))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ((pos_h, pos_t, src_perm, src_sorted, src_splits, dst_perm, dst_sorted,
          dst_splits, shift), a, edge_mask) = _hinge_weights(ctx, g)
        e, dev = pos_h.shape[0], pos_h.device
        fwd, back = _roll_index(e, shift, dev), _roll_index(e, -shift, dev)
        # Stream 1 (src-sorted): dh_e = a_e · (t_{e+k} − t_e). The rolled
        # rows are temporaries, freed as each line ends.
        t1 = a * (gather_rows(pos_t, fwd)[0] - pos_t)
        # Stream 2 (dst-sorted): dt_e = a_{e−k}·h_{e−k} − a_e·h_e.
        t2 = a * pos_h
        t3 = gather_rows(t2, back)[0] - t2
        n = ctx.num_nodes
        stream_src = t1 if src_perm is None else gather_rows(t1, src_perm)[0]
        stream_dst = t3 if dst_perm is None else gather_rows(t3, dst_perm)[0]
        for table, idx in ((pos_t, fwd), (t2, back), (t1, src_perm), (t3, dst_perm)):
            if idx is not None:
                count_gather(table, idx)
        dembs = sorted_segment_sum(
            stream_src, src_sorted, n, src_splits
        ) + sorted_segment_sum(stream_dst, dst_sorted, n, dst_splits)
        return (dembs.to(ctx.dtype),) + (None,) * 9 + (
            _mask_cotangent(ctx, edge_mask, 10), None)


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
    return _LinkPredictionLossSorted.apply(
        embs, src, dst,
        sort_plan.src_perm, sort_plan.src_sorted, sort_plan.src_splits,
        sort_plan.dst_perm, sort_plan.dst_sorted, sort_plan.dst_splits,
        roll_shift, _mask_or_ones(edge_mask, src, embs), margin,
    )
