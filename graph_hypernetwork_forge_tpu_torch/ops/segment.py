"""Segment reductions and the sort-free aggregation building blocks.

The port of ``graph_hypernetwork_forge_tpu/ops/segment.py``. The count-clamp
semantics are kept exactly, so isolated nodes aggregate to zero. The
aggregation tail runs sort-free: a host-precomputed permutation
(:class:`~graph_hypernetwork_forge_tpu_torch.data.encoding.SortPlan`) puts
the rows in segment order, and the CSR segment-sum kernel
(``ops/cuda/segment_sum.py``) reduces them by host-precomputed bounds.

The sorted building blocks are ``torch.autograd.Function``s with the JAX
package's gather-only backwards (its ``ops/segment.py:197-382``): no
backward scatters with unsorted indices. A gather's cotangent is permuted
into sorted order by the plan and reduced through the CSR segment-sum; a
segment-sum's cotangent is one row gather. Every row gather of these
Functions, forward and backward, goes through
:func:`~graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows.gather_rows`:
the gather kernel on the card, ``index_select`` on the CPU.

While spans record (``utils/profiling.py``), every row gather here, forward
and backward, adds its least bytes to the ``gather_bytes`` counter
(:func:`count_gather`).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows import gather_rows
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count, enabled


def gather_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """The least bytes of ``table[idx]`` on axis 0: each output row written
    once, each index read once, and each table row read once, or the whole
    table once where it has fewer rows than the output. The scatter-add of
    the output's cotangent back into the table moves the same bytes."""
    n = idx.numel()
    row = math.prod(table.shape[1:]) * table.element_size()
    return n * row + n * idx.element_size() + min(n, table.shape[0]) * row


def count_gather(table: torch.Tensor, idx: torch.Tensor, plain: bool = False) -> None:
    """Add :func:`gather_bytes` of ``table[idx]`` to ``gather_bytes`` while
    recording. ``plain=True`` marks a gather whose backward autograd runs
    (a plain ``table[idx]`` or ``index_select``): where autograd records it,
    its backward is counted here too, where its shapes are known."""
    if enabled():
        times = 2 if plain and table.requires_grad and torch.is_grad_enabled() else 1
        count("gather_bytes", times * gather_bytes(table, idx))


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


def _sorted_sum(values_sorted, ids_sorted, num_segments, splits):
    """The forward of :func:`sorted_segment_sum`, recording nothing."""
    if splits is not None and values_sorted.dim() == 2:
        # bf16 rows (speed mode) go to kernel 1's bf16 form, which sums
        # them in f32 as it reads them: no [E, d] f32 copy.
        if values_sorted.dtype == torch.float16:
            values_sorted = values_sorted.float()
        return csr_segment_sum(values_sorted.contiguous(), splits, num_segments)
    return segment_sum(values_sorted, ids_sorted, num_segments)


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values_sorted, ids_sorted, num_segments, splits):
        ctx.save_for_backward(ids_sorted)
        ctx.dtype = values_sorted.dtype
        return _sorted_sum(values_sorted, ids_sorted, num_segments, splits)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids_sorted,) = ctx.saved_tensors
        count_gather(g, ids_sorted)
        (rows,) = gather_rows(g, ids_sorted)
        return rows.to(ctx.dtype), None, None, None


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
    ``index_add_`` over ``ids_sorted``. The backward is the row gather
    ``g[ids_sorted]`` (``ops/pallas/segment_sum.py:228-235``).
    """
    return _SortedSegmentSum.apply(values_sorted, ids_sorted, num_segments, splits)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        count_gather(x, perm)
        (rows,) = gather_rows(x, perm)
        return rows

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        count_gather(g, inv_perm)
        (rows,) = gather_rows(g, inv_perm)
        return rows, None, None


def permute_rows(
    x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor
) -> torch.Tensor:
    """``x[perm]`` for a bijective ``perm`` with ``inv_perm[perm[i]] == i``;
    the backward is the gather ``g[inv_perm]``."""
    return _PermuteRows.apply(x, perm, inv_perm)


def _reduce_sorted(g, perm_to_sorted, idx_sorted, splits, num_rows):
    """A gather's cotangent summed into table rows: permute to sorted order
    (``perm_to_sorted`` None means already sorted), then segment-sum."""
    if perm_to_sorted is not None:
        count_gather(g, perm_to_sorted)
        (g,) = gather_rows(g, perm_to_sorted)
    return _sorted_sum(g, idx_sorted, num_rows, splits)


def reduce_unsorted(g, idx, num_rows):
    """``g``'s rows summed into ``num_rows`` table rows by ``idx``, the
    cotangent of ``table[idx]``, with no atomics: a stable sort of ``idx``
    and its CSR bounds, both on its device (no host read), then kernel 1 in
    that fixed order. Bitwise deterministic, and a row that many entries of
    ``idx`` name costs no more than its entries."""
    idx_sorted, perm = torch.sort(idx, stable=True)
    splits = torch.searchsorted(
        idx_sorted,
        torch.arange(num_rows + 1, device=idx.device, dtype=idx_sorted.dtype),
        out_int32=True,
    )
    return _reduce_sorted(g, perm, idx_sorted, splits, num_rows)


class _TakeRowsSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, perm_to_sorted, idx_sorted, splits):
        ctx.save_for_backward(perm_to_sorted, idx_sorted, splits)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        count_gather(table, idx)
        (rows,) = gather_rows(table, idx)
        return rows

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        perm, idx_sorted, splits = ctx.saved_tensors
        dtable = _reduce_sorted(g, perm, idx_sorted, splits, ctx.num_rows)
        return dtable.to(ctx.dtype), None, None, None, None


def take_rows_sorted(
    table: torch.Tensor,
    idx: torch.Tensor,
    perm_to_sorted: torch.Tensor | None,
    idx_sorted: torch.Tensor,
    splits: torch.Tensor | None = None,
) -> torch.Tensor:
    """``table[idx]`` whose backward reduces with sorted indices.

    ``perm_to_sorted`` puts ``idx`` in non-decreasing order
    (``idx[perm_to_sorted] == idx_sorted``), or is None when ``idx`` is
    already sorted; ``splits`` are ``idx_sorted``'s optional ``[rows + 1]``
    CSR bounds (``SortPlan.src_splits`` and the like), which send the
    backward's reduction to the CSR segment-sum.
    """
    return _TakeRowsSorted.apply(table, idx, perm_to_sorted, idx_sorted, splits)


class _TakeRowsPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx_a, idx_b, perm_a, sorted_a, splits_a,
                perm_b, sorted_b, splits_b):
        ctx.save_for_backward(perm_a, sorted_a, splits_a, perm_b, sorted_b, splits_b)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        count_gather(table, idx_a)
        count_gather(table, idx_b)
        return gather_rows(table, idx_a, idx_b)

    @staticmethod
    @once_differentiable
    def backward(ctx, ga, gb):
        perm_a, sorted_a, splits_a, perm_b, sorted_b, splits_b = ctx.saved_tensors
        n = ctx.num_rows
        # Two single-stream reductions, added (JAX ops/segment.py:314-335).
        dtable = _reduce_sorted(ga, perm_a, sorted_a, splits_a, n) + _reduce_sorted(
            gb, perm_b, sorted_b, splits_b, n
        )
        return (dtable.to(ctx.dtype),) + (None,) * 8


def take_rows_pair(
    table: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    perm_a: torch.Tensor | None,
    sorted_a: torch.Tensor,
    splits_a: torch.Tensor | None,
    perm_b: torch.Tensor | None,
    sorted_b: torch.Tensor,
    splits_b: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table[idx_a], table[idx_b])`` with one summed-cotangent backward:
    the per-layer ``h[src]``, ``h[dst]`` pair. Each stream's arguments are
    those of one :func:`take_rows_sorted` call."""
    return _TakeRowsPair.apply(
        table, idx_a, idx_b, perm_a, sorted_a, splits_a, perm_b, sorted_b, splits_b
    )


class _SortedSegmentSumByPlan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, perm_to_sorted, inv_perm, ids_sorted, num_segments,
                splits):
        ctx.save_for_backward(inv_perm, ids_sorted)
        ctx.dtype = values.dtype
        count_gather(values, perm_to_sorted)
        (values_sorted,) = gather_rows(values, perm_to_sorted)
        return _sorted_sum(values_sorted, ids_sorted, num_segments, splits)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inv_perm, ids_sorted = ctx.saved_tensors
        # One [E] index gather composes the two row gathers into one
        # (JAX ops/segment.py:373-379): dvalues[i] = g[ids_sorted[inv_perm[i]]].
        (idx,) = gather_rows(ids_sorted, inv_perm)
        count_gather(ids_sorted, inv_perm)
        count_gather(g, idx)
        (rows,) = gather_rows(g, idx)
        return rows.to(ctx.dtype), None, None, None, None, None


def sorted_segment_sum_by_plan(
    values: torch.Tensor,
    perm_to_sorted: torch.Tensor,
    inv_perm: torch.Tensor,
    ids_sorted: torch.Tensor,
    num_segments: int,
    splits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-sum of unsorted rows through a precomputed sort permutation.

    Equal to ``segment_sum(values, ids, num_segments)`` where
    ``ids[perm_to_sorted] == ids_sorted`` and ``inv_perm`` inverts
    ``perm_to_sorted``: one row gather, then one sorted reduction. The
    backward is one row gather.
    """
    return _SortedSegmentSumByPlan.apply(
        values, perm_to_sorted, inv_perm, ids_sorted, num_segments, splits
    )
