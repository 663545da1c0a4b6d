"""Kernel 1: CSR sorted segment-sum (``csrc/segment_sum.cu``).

``out[n] = sum(x_sorted[splits[n]:splits[n + 1]])`` over rows already
sorted by segment id, with host-precomputed CSR bounds ``splits``
(``SortPlan.dst_splits`` and the like). The output is float32 and empty
segments are 0. This is the function of the TPU kernels
``sorted_segment_sum_pallas`` and ``sorted_segment_sum_packed64``
(``graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:198,415``).

On the card the kernel splits the rows into fixed chunks, one warp each,
and adds the pieces of segments that cross chunks in a second pass, so a
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
    lib.ghf_csr_rows_per_chunk.restype = ctypes.c_int
    return lib


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
    _common.require_cuda(
        _NAME, dev, ("x_sorted", x_sorted, torch.float32),
        ("splits", splits, torch.int32),
    )
    if x_sorted.dim() != 2 or splits.dim() != 1:
        raise ValueError(f"{_NAME}: needs x_sorted [R, d] and splits [>= N + 1]")
    if splits.shape[0] < num_segments + 1:
        raise ValueError(
            f"{_NAME}: splits has {splits.shape[0]} entries, needs "
            f"num_segments + 1 = {num_segments + 1}"
        )
    rows, d = (int(s) for s in x_sorted.shape)
    lib = _lib()
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    # Scratch for the pieces of segments that cross row chunks.
    chunks = -(-rows // lib.ghf_csr_rows_per_chunk())
    partial = torch.empty((2 * chunks * d,), dtype=torch.float32, device=dev)
    vec = 4 if d % 4 == 0 and x_sorted.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(dev):
        code = lib.ghf_csr_segment_sum(
            _common.ptr(x_sorted), _common.ptr(splits), _common.ptr(out),
            _common.ptr(partial), rows, num_segments, d, vec,
            _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    csr_segment_sum.launches += 1
    return out


csr_segment_sum.launches = 0
