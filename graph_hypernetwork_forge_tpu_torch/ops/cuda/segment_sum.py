"""Kernels 1 and 7: CSR sorted segment-sums (``csrc/segment_sum.cu``).

Kernel 1, :func:`csr_segment_sum`: ``out[n] = sum(x_sorted[splits[n]:
splits[n + 1]])`` over rows already sorted by segment id, with
host-precomputed CSR bounds ``splits`` (``SortPlan.dst_splits`` and the
like). The output is float32 and empty segments are 0. This is the function
of the TPU kernels ``sorted_segment_sum_pallas`` and
``sorted_segment_sum_packed64``
(``graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:198,415``).

Kernel 7, :func:`dual_sorted_segment_sum`: two such sums, each stream with
its own bounds, in one pass: the function of the TPU kernel
``dual_sorted_segment_sum_pallas`` (same file, :463). Forward only, as
there.

On the card each kernel is one launch. It splits the rows into fixed
blocks, and each block's lane groups sum consecutive spans of rows as
segmented sums; the pieces of segments that cross spans are joined in the
block, and those that cross blocks by the block that draws a segment's last
ticket (int32 counters, left at zero). Zero blocks at the end of the grid,
2048 segments each, write the empty segments' zeros. So a segment of any
length costs no more than its rows, a run of empty segments no more than
its zero rows, and the sums are bitwise deterministic. Both kernels
also take bf16 rows (the speed mode's, the TPU
kernels' bf16 branch): read as bf16, summed and written in f32. And both
take the TPU kernels' ``mode``: ``"exact"``, or ``"fast"``, in which f32
rows are rounded to bf16 (to nearest even) as they are read and then summed
in f32; on bf16 rows the mode changes nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load

_NAME = "csr_segment_sum"


def csr_segment_sum_plain(
    x_sorted: torch.Tensor, splits: torch.Tensor, num_segments: int,
    mode: str = "exact",
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` over ids expanded from ``splits``.

    Sums in float32 (bf16 rows upcast first), or in float64 for float64
    rows (the gradient checks); ``mode="fast"`` rounds the rows to bf16
    first.
    """
    fast = _common.sum_form(x_sorted.dtype, mode) == "fast"
    s = splits[: num_segments + 1].long()
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=x_sorted.device), s[1:] - s[:-1]
    )
    dtype = torch.promote_types(x_sorted.dtype, torch.float32)
    out = torch.zeros(
        (num_segments,) + tuple(x_sorted.shape[1:]),
        dtype=dtype, device=x_sorted.device,
    )
    rows = x_sorted[s[0]: s[-1]]
    if fast:
        rows = rows.bfloat16()
    return out.index_add_(0, ids, rows.to(dtype))


# The forms of kernels 1 and 7 (``_common.sum_form``): their C entries, and
# the elements one 16-byte load reads.
_ENTRY = dict(f32="ghf_csr_segment_sum", bf16="ghf_csr_segment_sum_bf16",
              fast="ghf_csr_segment_sum_fast")
_DUAL_ENTRY = dict(f32="ghf_dual_csr_segment_sum", bf16="ghf_dual_csr_segment_sum_bf16",
                   fast="ghf_dual_csr_segment_sum_fast")
_VEC = dict(f32=4, bf16=8, fast=4)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("segment_sum")
    stream = [ctypes.c_void_p] * 4 + [ctypes.c_int64]
    tail = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for form in _ENTRY:
        one, dual = getattr(lib, _ENTRY[form]), getattr(lib, _DUAL_ENTRY[form])
        one.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + tail
        dual.argtypes = stream * 2 + [ctypes.c_void_p] + tail
        one.restype = dual.restype = ctypes.c_int
    lib.ghf_csr_rows_per_block.restype = ctypes.c_int
    return lib


def _check_stream(name, dev, x_sorted, splits, num_segments) -> None:
    """Device, dtype, contiguity and shape checks of one CSR stream."""
    _common.require_cuda(
        name, dev, ("x_sorted", x_sorted, _common.F32_BF16),
        ("splits", splits, torch.int32),
    )
    if x_sorted.dim() != 2 or splits.dim() != 1:
        raise ValueError(f"{name}: needs x_sorted [R, d] and splits [>= N + 1]")
    if splits.shape[0] < num_segments + 1:
        raise ValueError(
            f"{name}: splits has {splits.shape[0]} entries, needs "
            f"num_segments + 1 = {num_segments + 1}"
        )


@functools.cache
def _rows_per_block() -> int:
    return _lib().ghf_csr_rows_per_block()


def _blocks(rows: int) -> int:
    """Row blocks of one stream, at least one (as the kernel counts them)."""
    return max(1, -(-rows // _rows_per_block()))


def _launch(name, entry, form, dev, streams, num_segments, d) -> list[torch.Tensor]:
    """One launch of ``entry`` over ``streams`` (``(x_sorted, splits)``
    pairs of one shape and dtype) → their f32 sums. Sizes the scratch (two
    pieces a row block) and the ticket counters (one per row block and
    32-lane column window, kept per stream by ``_common.run_counters``)."""
    rows = int(streams[0][0].shape[0])
    blocks = _blocks(rows)
    outs = [torch.empty((num_segments, d), dtype=torch.float32, device=dev) for _ in streams]
    parts = [torch.empty((2 * blocks * d,), dtype=torch.float32, device=dev) for _ in streams]
    dtype = streams[0][0].dtype
    vec = _VEC[form] if _common.vec16(*(x for x, _ in streams), *outs, *parts,
                                      widths=(d,), dtype=dtype) else 1
    windows = max(1, -(-(d // vec) // 32))
    stream = torch.cuda.current_stream(dev)
    counters = _common.run_counters(dev, len(streams) * blocks * windows, stream)
    args = []
    for (x, splits), out, part in zip(streams, outs, parts):
        args += [x.data_ptr(), splits.data_ptr(), out.data_ptr(), part.data_ptr()]
        if len(streams) == 1:
            args.append(counters.data_ptr())
        args.append(rows)
    if len(streams) == 2:
        args.append(counters.data_ptr())
    with torch.cuda.device(dev):
        code = entry(*args, num_segments, d, vec, stream.cuda_stream)
    _common.raise_on_error(name, code)
    return outs


def csr_segment_sum(
    x_sorted: torch.Tensor, splits: torch.Tensor, num_segments: int,
    mode: str = "exact",
) -> torch.Tensor:
    """Segment-sum of ``x_sorted [R, d]`` by CSR bounds → ``[num_segments, d]`` f32.

    ``splits`` holds at least ``num_segments + 1`` non-decreasing int32
    row bounds with ``splits[num_segments] <= R``; only those are read.
    ``mode``: ``"exact"``, or ``"fast"`` (f32 rows rounded to bf16 before
    the f32 sums; no change for bf16 rows), as the TPU kernel's. CPU
    tensors take :func:`csr_segment_sum_plain`; CUDA tensors launch the
    kernel (float32 or bfloat16 rows, summed in f32; int32 splits; both
    contiguous) or raise.
    """
    form = _common.sum_form(x_sorted.dtype, mode)
    if x_sorted.device.type == "cpu":
        return csr_segment_sum_plain(x_sorted, splits, num_segments, mode)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x_sorted.device}")
    _common.require_inference(_NAME, x_sorted)
    dev = x_sorted.device
    _check_stream(_NAME, dev, x_sorted, splits, num_segments)
    (out,) = _launch(_NAME, getattr(_lib(), _ENTRY[form]), form, dev,
                     [(x_sorted, splits)], num_segments, int(x_sorted.shape[1]))
    _common.count_launch(csr_segment_sum, form)
    return out


_common.reset_counts(csr_segment_sum)

_DUAL = "dual_sorted_segment_sum"


def dual_sorted_segment_sum_plain(
    xa_sorted: torch.Tensor,
    xb_sorted: torch.Tensor,
    num_segments: int,
    splits_a: torch.Tensor,
    splits_b: torch.Tensor,
    mode: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: two :func:`csr_segment_sum_plain` calls."""
    return (
        csr_segment_sum_plain(xa_sorted, splits_a, num_segments, mode),
        csr_segment_sum_plain(xb_sorted, splits_b, num_segments, mode),
    )


def dual_sorted_segment_sum(
    xa_sorted: torch.Tensor,
    xb_sorted: torch.Tensor,
    num_segments: int,
    splits_a: torch.Tensor,
    splits_b: torch.Tensor,
    mode: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent CSR segment-sums in one pass → ``(sum_a, sum_b)``,
    each ``[num_segments, d]`` f32.

    ``xa_sorted`` and ``xb_sorted`` are ``[E, d]`` row streams, each sorted
    by its own segment ids with CSR bounds ``splits_a`` / ``splits_b``
    (``[>= num_segments + 1]`` int32, host-precomputed: for example
    ``SortPlan.src_splits`` and ``dst_splits``, the cotangent pair of a
    layer's ``h[src]``, ``h[dst]`` gathers). Forward only, as the JAX
    package's ``dual_sorted_segment_sum_pallas``: inputs that want a
    gradient are refused. ``mode`` as :func:`csr_segment_sum`'s. CPU
    tensors take :func:`dual_sorted_segment_sum_plain`; CUDA tensors launch
    kernel 7 (float32 or bfloat16 rows, one dtype for both streams; int32
    splits; all contiguous, on one device) or raise.
    """
    _common.require_inference(_DUAL, xa_sorted, xb_sorted)
    form = _common.sum_form(xa_sorted.dtype, mode)
    if xa_sorted.shape != xb_sorted.shape:
        raise ValueError(
            f"{_DUAL}: streams {tuple(xa_sorted.shape)} and "
            f"{tuple(xb_sorted.shape)} differ in shape"
        )
    if xa_sorted.device.type == "cpu":
        return dual_sorted_segment_sum_plain(
            xa_sorted, xb_sorted, num_segments, splits_a, splits_b, mode
        )
    if xa_sorted.device.type != "cuda":
        raise ValueError(f"{_DUAL}: unsupported device {xa_sorted.device}")
    dev = xa_sorted.device
    _check_stream(_DUAL, dev, xa_sorted, splits_a, num_segments)
    _check_stream(_DUAL, dev, xb_sorted, splits_b, num_segments)
    _common.require_same_dtype(_DUAL, xa_sorted=xa_sorted, xb_sorted=xb_sorted)
    out_a, out_b = _launch(_DUAL, getattr(_lib(), _DUAL_ENTRY[form]), form, dev,
                           [(xa_sorted, splits_a), (xb_sorted, splits_b)],
                           num_segments, int(xa_sorted.shape[1]))
    _common.count_launch(dual_sorted_segment_sum, form)
    return out_a, out_b


_common.reset_counts(dual_sorted_segment_sum)
