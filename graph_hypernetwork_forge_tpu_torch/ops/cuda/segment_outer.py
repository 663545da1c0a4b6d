"""Kernel 6: segment outer product over single-relation tiles (``csrc/segment_outer.cu``).

``dW[u] = Σ_{e: r=u} x[e]ᵀ g[e]`` with ``r = rel_sorted[(e // 256) * 256]``:
the edge rows are relation-sorted and group-padded, so each 256-row tile
holds one relation and takes it from its first row (a ragged last tile
too). Relations that no tile visits come out exactly zero. This is the
function of the TPU kernel ``_segment_outer_impl``
(``graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473``), the
weight gradient of ``edge_transform_sorted``.

On the card the kernel writes one ``[d_in, d_out]`` partial per run of up
to :data:`RUN_TILES` consecutive tiles of one relation
(``edge_transform_bwd.run_bounds``), as kernel 3 does for its dW, and
kernel 1 (``csr_segment_sum``) adds each relation's partials over the run
bounds: one call of this wrapper launches kernel 6 once and kernel 1 once,
and the result is bitwise deterministic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    as_tiles,
    run_bounds,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum

_NAME = "segment_outer"

# Tiles of one relation that one kernel-6 block walks: 2 gives 2,131 runs
# at the xl layout (E_pad = 1,031,680, U = 237), partials of 35 MB at d=64
# and 140 MB at d=128. On the H100 runs of 2 were the fastest of 1, 2, 4
# and 8 tiles at both widths (scripts/tune_edge_kernels.py); kernel 3 keeps
# runs of 4, its own fastest.
RUN_TILES = 2


def segment_outer_plain(
    x: torch.Tensor, g: torch.Tensor, rel_sorted: torch.Tensor, num_rel: int
) -> torch.Tensor:
    """Plain PyTorch version: per-tile ``bmm`` of ``xᵀ`` against ``g``, then
    the per-tile products summed into their relations by ``index_add_``."""
    tile_rel = rel_sorted[::GROUP_PAD].long()
    part = torch.bmm(as_tiles(x).transpose(1, 2), as_tiles(g))  # [tiles, d_in, d_out]
    return part.new_zeros((num_rel,) + tuple(part.shape[1:])).index_add_(
        0, tile_rel, part
    )


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("segment_outer")
    fn = lib.ghf_segment_outer
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def segment_outer(
    x: torch.Tensor, g: torch.Tensor, rel_sorted: torch.Tensor, num_rel: int
) -> torch.Tensor:
    """``dW [num_rel, d_in, d_out]`` f32 from ``x [E, d_in]`` and ``g [E, d_out]``.

    ``rel_sorted`` is ``[E]``, non-decreasing, each relation's group
    starting on a 256-row boundary. CPU tensors take
    :func:`segment_outer_plain`; CUDA tensors launch the kernel (float32
    data, int32 ids, all contiguous) or raise. A forward-only launch:
    ``edge_transform_sorted``'s autograd Function calls it from its backward.
    """
    if x.device.type == "cpu":
        return segment_outer_plain(x, g, rel_sorted, num_rel)
    if x.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x.device}")
    _common.require_inference(_NAME, x, g)
    dev = x.device
    f32 = torch.float32
    _common.require_cuda(
        _NAME, dev, ("x", x, f32), ("g", g, f32),
        ("rel_sorted", rel_sorted, torch.int32),
    )
    e, d_in = x.shape
    if g.dim() != 2 or g.shape[0] != e or rel_sorted.shape != (e,):
        raise ValueError(
            f"{_NAME}: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"rel_sorted {tuple(rel_sorted.shape)} do not fit together"
        )
    d_out = g.shape[1]
    t_splits, r_splits, max_runs = run_bounds(rel_sorted, num_rel, RUN_TILES)
    partial = torch.empty((max_runs, d_in * d_out), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().ghf_segment_outer(
            _common.ptr(x), _common.ptr(g), _common.ptr(t_splits),
            _common.ptr(r_splits), _common.ptr(partial), e, d_in, d_out, num_rel,
            RUN_TILES, max_runs, _common.vec16(x, g, partial, widths=(d_in, d_out)),
            _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    segment_outer.launches += 1
    dw = csr_segment_sum(partial, r_splits, num_rel)
    return dw.view(num_rel, d_in, d_out)


segment_outer.launches = 0
