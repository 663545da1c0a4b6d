"""The row gather ``table[idx]`` on axis 0 (``csrc/gather_rows.cu``).

:func:`gather_rows` takes one table and one to three index streams and
returns ``table.index_select(0, idx)`` for each, bit for bit. On the card
the streams are one launch of ``gather_rows_kernel``, which moves many rows
per warp with several rows in flight a lane, where PyTorch's
``index_select`` runs one warp per row. It replaces no TPU kernel: the JAX
package leaves these gathers to XLA. CPU tensors take
:func:`gather_rows_plain`, which is ``index_select`` itself.

Each launch counts one in ``kernel.gather_rows.<form>``, the form being the
bytes each lane moves at a time: ``v16``, ``v8``, ``v4``, ``v2`` or ``v1``,
the widest that divides the row's bytes and the table's and outputs'
addresses.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load

_NAME = "gather_rows"
MAX_STREAMS = 3
# Bytes a lane moves at a time, widest first; the kernel's forms.
VECTOR_BYTES = (16, 8, 4, 2, 1)
INDEX_DTYPES = (torch.int32, torch.int64)


def gather_rows_plain(table: torch.Tensor, *indices: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version: ``table.index_select(0, idx)`` for each index."""
    return tuple(table.index_select(0, idx) for idx in indices)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("gather_rows")
    stream = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    lib.ghf_gather_rows.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        + stream * MAX_STREAMS + [ctypes.c_void_p]
    )
    lib.ghf_gather_rows.restype = ctypes.c_int
    return lib


def vector_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest of :data:`VECTOR_BYTES` that divides ``row_bytes`` and the
    address of every tensor."""
    return next(v for v in VECTOR_BYTES
                if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors))


def gather_rows(table: torch.Tensor, *indices: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(table[idx] for idx in indices)`` along axis 0, one to three 1-D
    int32 or int64 indices (they may differ in dtype) over one table of any
    dtype and shape.

    Bit for bit ``table.index_select(0, idx)``. CPU tensors take
    :func:`gather_rows_plain`; CUDA tensors launch the kernel once for all
    the indices, or raise. Indices are not checked against the table's rows
    on the card, and nothing is read back to the host, so a CUDA graph can
    capture the launch.
    """
    if not 1 <= len(indices) <= MAX_STREAMS:
        raise ValueError(f"{_NAME}: takes 1 to {MAX_STREAMS} indices, got {len(indices)}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, *indices)
    if table.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {table.device}")
    _common.require_inference(_NAME, table)
    if table.dim() < 1:
        raise ValueError(f"{_NAME}: the table needs at least one axis")
    dev = table.device
    indices = tuple(idx.contiguous() for idx in indices)
    for idx in indices:
        _common.require_cuda(_NAME, dev, ("an index", idx, INDEX_DTYPES))
        if idx.dim() != 1:
            raise ValueError(f"{_NAME}: an index must be 1-D, got shape {tuple(idx.shape)}")
    table = table.contiguous()
    outs = tuple(torch.empty((idx.shape[0],) + table.shape[1:], dtype=table.dtype, device=dev)
                 for idx in indices)
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    streams = [(idx, out) for idx, out in zip(indices, outs) if idx.numel() > 0]
    if row_bytes == 0 or not streams:
        return outs
    vec = vector_bytes(row_bytes, table, *(out for _, out in streams))
    args = []
    for k in range(MAX_STREAMS):
        idx, out = streams[k] if k < len(streams) else (None, None)
        args += [_common.ptr(idx), int(idx is not None and idx.dtype == torch.int64),
                 _common.ptr(out), 0 if idx is None else idx.shape[0]]
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        code = _lib().ghf_gather_rows(table.data_ptr(), row_bytes, vec, len(streams), *args,
                                      stream.cuda_stream)
    _common.raise_on_error(_NAME, code)
    _common.count_launch(_NAME, f"v{vec}")
    return outs
