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

On the card the kernels split the rows into fixed chunks, one warp each,
and add the pieces of segments that cross chunks in a second pass, so a
segment of any length costs no more than its rows; the sums are bitwise
deterministic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load

_NAME = "csr_segment_sum"


def csr_segment_sum_plain(
    x_sorted: torch.Tensor, splits: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` over ids expanded from ``splits``.

    Sums in float32, or in float64 for float64 rows (the gradient checks).
    """
    s = splits[: num_segments + 1].long()
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=x_sorted.device), s[1:] - s[:-1]
    )
    dtype = torch.promote_types(x_sorted.dtype, torch.float32)
    out = torch.zeros(
        (num_segments,) + tuple(x_sorted.shape[1:]),
        dtype=dtype, device=x_sorted.device,
    )
    return out.index_add_(0, ids, x_sorted[s[0]: s[-1]].to(dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("segment_sum")
    fn = lib.ghf_csr_segment_sum
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    dual = lib.ghf_dual_csr_segment_sum
    stream = [ctypes.c_void_p] * 4 + [ctypes.c_int64]
    dual.argtypes = stream * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dual.restype = ctypes.c_int
    lib.ghf_csr_rows_per_chunk.restype = ctypes.c_int
    return lib


def _check_stream(name, dev, x_sorted, splits, num_segments) -> None:
    """Device, dtype, contiguity and shape checks of one CSR stream."""
    _common.require_cuda(
        name, dev, ("x_sorted", x_sorted, torch.float32),
        ("splits", splits, torch.int32),
    )
    if x_sorted.dim() != 2 or splits.dim() != 1:
        raise ValueError(f"{name}: needs x_sorted [R, d] and splits [>= N + 1]")
    if splits.shape[0] < num_segments + 1:
        raise ValueError(
            f"{name}: splits has {splits.shape[0]} entries, needs "
            f"num_segments + 1 = {num_segments + 1}"
        )


def _scratch(lib, rows: int, d: int, dev) -> torch.Tensor:
    """Scratch for the pieces of segments that cross row chunks."""
    chunks = -(-rows // lib.ghf_csr_rows_per_chunk())
    return torch.empty((2 * chunks * d,), dtype=torch.float32, device=dev)


def csr_segment_sum(
    x_sorted: torch.Tensor, splits: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segment-sum of ``x_sorted [R, d]`` by CSR bounds → ``[num_segments, d]`` f32.

    ``splits`` holds at least ``num_segments + 1`` non-decreasing int32
    row bounds with ``splits[num_segments] <= R``; only those are read.
    CPU tensors take :func:`csr_segment_sum_plain`; CUDA tensors launch the
    kernel (float32 rows, int32 splits, both contiguous) or raise.
    """
    if x_sorted.device.type == "cpu":
        return csr_segment_sum_plain(x_sorted, splits, num_segments)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x_sorted.device}")
    _common.require_inference(_NAME, x_sorted)
    dev = x_sorted.device
    _check_stream(_NAME, dev, x_sorted, splits, num_segments)
    rows, d = (int(s) for s in x_sorted.shape)
    lib = _lib()
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    partial = _scratch(lib, rows, d, dev)
    with torch.cuda.device(dev):
        code = lib.ghf_csr_segment_sum(
            _common.ptr(x_sorted), _common.ptr(splits), _common.ptr(out),
            _common.ptr(partial), rows, num_segments, d,
            4 if _common.vec16(x_sorted, widths=(d,)) else 1,
            _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    csr_segment_sum.launches += 1
    return out


csr_segment_sum.launches = 0

_DUAL = "dual_sorted_segment_sum"


def dual_sorted_segment_sum_plain(
    xa_sorted: torch.Tensor,
    xb_sorted: torch.Tensor,
    num_segments: int,
    splits_a: torch.Tensor,
    splits_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: two :func:`csr_segment_sum_plain` calls."""
    return (
        csr_segment_sum_plain(xa_sorted, splits_a, num_segments),
        csr_segment_sum_plain(xb_sorted, splits_b, num_segments),
    )


def dual_sorted_segment_sum(
    xa_sorted: torch.Tensor,
    xb_sorted: torch.Tensor,
    num_segments: int,
    splits_a: torch.Tensor,
    splits_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent CSR segment-sums in one pass → ``(sum_a, sum_b)``,
    each ``[num_segments, d]`` f32.

    ``xa_sorted`` and ``xb_sorted`` are ``[E, d]`` row streams, each sorted
    by its own segment ids with CSR bounds ``splits_a`` / ``splits_b``
    (``[>= num_segments + 1]`` int32, host-precomputed: for example
    ``SortPlan.src_splits`` and ``dst_splits``, the cotangent pair of a
    layer's ``h[src]``, ``h[dst]`` gathers). Forward only, as the JAX
    package's ``dual_sorted_segment_sum_pallas``: inputs that want a
    gradient are refused. CPU tensors take
    :func:`dual_sorted_segment_sum_plain`; CUDA tensors launch kernel 7
    (float32 rows, int32 splits, all contiguous, on one device) or raise.
    """
    _common.require_inference(_DUAL, xa_sorted, xb_sorted)
    if xa_sorted.shape != xb_sorted.shape:
        raise ValueError(
            f"{_DUAL}: streams {tuple(xa_sorted.shape)} and "
            f"{tuple(xb_sorted.shape)} differ in shape"
        )
    if xa_sorted.device.type == "cpu":
        return dual_sorted_segment_sum_plain(
            xa_sorted, xb_sorted, num_segments, splits_a, splits_b
        )
    if xa_sorted.device.type != "cuda":
        raise ValueError(f"{_DUAL}: unsupported device {xa_sorted.device}")
    dev = xa_sorted.device
    _check_stream(_DUAL, dev, xa_sorted, splits_a, num_segments)
    _check_stream(_DUAL, dev, xb_sorted, splits_b, num_segments)
    rows, d = (int(s) for s in xa_sorted.shape)
    lib = _lib()
    out_a, out_b = (
        torch.empty((num_segments, d), dtype=torch.float32, device=dev)
        for _ in range(2)
    )
    part_a, part_b = (_scratch(lib, rows, d, dev) for _ in range(2))
    with torch.cuda.device(dev):
        code = lib.ghf_dual_csr_segment_sum(
            _common.ptr(xa_sorted), _common.ptr(splits_a), _common.ptr(out_a),
            _common.ptr(part_a), rows,
            _common.ptr(xb_sorted), _common.ptr(splits_b), _common.ptr(out_b),
            _common.ptr(part_b), rows,
            num_segments, d, 4 if _common.vec16(xa_sorted, xb_sorted, widths=(d,)) else 1,
            _common.stream_of(dev),
        )
    _common.raise_on_error(_DUAL, code)
    dual_sorted_segment_sum.launches += 1
    return out_a, out_b


dual_sorted_segment_sum.launches = 0
