"""Segment reductions and the sort-free aggregation building blocks (forward).

The port of ``graph_hypernetwork_forge_tpu/ops/segment.py``. The count-clamp
semantics are kept exactly, so isolated nodes aggregate to zero. The
aggregation tail runs sort-free: a host-precomputed permutation
(:class:`~graph_hypernetwork_forge_tpu_torch.data.encoding.SortPlan`) puts
the rows in segment order, and the CSR segment-sum kernel
(``ops/cuda/segment_sum.py``) reduces them by host-precomputed bounds.

Forward only: the gather-only backwards of the JAX package come with the
training slice.
"""

from __future__ import annotations

import torch

from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets keyed by ``segment_ids``.

    Accumulates in float32 (bf16 data is upcast first).
    """
    if data.dtype == torch.bfloat16:
        data = data.float()
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Count (or weighted count) of entries per segment → ``[num_segments]`` f32."""
    ones = (
        torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device)
        if weights is None else weights
    )
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean_clamped(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean per segment with the count clamped to >= 1 (empty segments → 0).

    Returns ``(mean [S, d], clamped_count [S])``.
    """
    if weights is not None:
        data = data * weights[:, None]
    total = segment_sum(data, segment_ids, num_segments)
    cnt = segment_count(segment_ids, num_segments, weights).clamp(min=1.0)
    return total / cnt[:, None], cnt


def sorted_segment_sum(
    values_sorted: torch.Tensor,
    ids_sorted: torch.Tensor,
    num_segments: int,
    splits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-sum of rows already sorted by id → ``[num_segments, d]`` f32.

    With host-precomputed CSR bounds ``splits`` (``[>= num_segments + 1]``)
    a 2-D input goes to the CSR segment-sum (the kernel on a CUDA tensor,
    its plain version on the CPU), at any width. Without them, an
    ``index_add_`` over ``ids_sorted``.
    """
    if splits is not None and values_sorted.dim() == 2:
        return csr_segment_sum(values_sorted.float(), splits, num_segments)
    return segment_sum(values_sorted, ids_sorted, num_segments)


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a bijective ``perm``."""
    return x.index_select(0, perm)


def take_rows_pair(
    table: torch.Tensor, idx_a: torch.Tensor, idx_b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table[idx_a], table[idx_b])``: the per-layer ``h[src]``, ``h[dst]``."""
    return table.index_select(0, idx_a), table.index_select(0, idx_b)


def sorted_segment_sum_by_plan(
    values: torch.Tensor,
    perm_to_sorted: torch.Tensor,
    ids_sorted: torch.Tensor,
    num_segments: int,
    splits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-sum of unsorted rows through a precomputed sort permutation.

    Equal to ``segment_sum(values, ids, num_segments)`` where
    ``ids[perm_to_sorted] == ids_sorted``: one row gather, then one sorted
    reduction.
    """
    values_sorted = permute_rows(values, perm_to_sorted)
    return sorted_segment_sum(values_sorted, ids_sorted, num_segments, splits)
