"""Kernel 6: segment outer product over single-relation tiles (``csrc/segment_outer.cu``).

``dW[u] = Σ_{e: r=u} x[e]ᵀ g[e]`` with ``r = rel_sorted[(e // 256) * 256]``:
the edge rows are relation-sorted and group-padded, so each 256-row tile
holds one relation and takes it from its first row (a ragged last tile
too). Relations that no tile visits come out exactly zero. This is the
function of the TPU kernel ``_segment_outer_impl``
(``graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473``), the
weight gradient of ``edge_transform_sorted``.

On the card one launch of kernel 6 computes dW: each block walks a run of
up to ``run_tiles`` consecutive tiles of one relation (a ``RunTable``, as
kernel 3's), and the relation's runs add their f32 partials inside the
kernel, in run order, in the block that finishes last
(``csrc/run_reduce.cuh``): bitwise deterministic, no float atomics, no
second launch. The run table comes from the caller's SortPlan
(``edge_transform_bwd.plan_runs``), or, without one, from one launch of
the run-table kernel per call. Kernel 6 takes bf16 data (one pass, the
partials and dW summed in f32) and, for f32 data, ``precision="default"``
(one TF32 pass instead of 3xTF32), as the TPU kernel's ``precision`` and
bf16 branch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD, RUN_TILES
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    RunTable,
    as_tiles,
    max_runs,
    require_runs,
    run_table,
)

_NAME = "segment_outer"


def segment_outer_plain(
    x: torch.Tensor, g: torch.Tensor, rel_sorted: torch.Tensor, num_rel: int
) -> torch.Tensor:
    """Plain PyTorch version: per-tile ``bmm`` of ``xᵀ`` against ``g``, then
    the per-tile products summed into their relations by ``index_add_``.

    Sums in float32, bf16 data upcast first (its products are exact in
    f32), as the TPU kernel sums across a relation's tiles; float64 data in
    float64 (the references of the error checks).
    """
    dtype = torch.promote_types(x.dtype, torch.float32)
    tile_rel = rel_sorted[::GROUP_PAD].long()
    part = torch.bmm(  # [tiles, d_in, d_out]
        as_tiles(x.to(dtype)).transpose(1, 2), as_tiles(g.to(dtype))
    )
    return part.new_zeros((num_rel,) + tuple(part.shape[1:])).index_add_(
        0, tile_rel, part
    )


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("segment_outer")
    fn = lib.ghf_segment_outer
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = lib.ghf_segment_outer_bf16
    bf16.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bf16.restype = ctypes.c_int
    return lib


def segment_outer(
    x: torch.Tensor, g: torch.Tensor, rel_sorted: torch.Tensor, num_rel: int,
    precision="highest", runs: RunTable | None = None,
) -> torch.Tensor:
    """``dW [num_rel, d_in, d_out]`` f32 from ``x [E, d_in]`` and ``g [E, d_out]``.

    ``rel_sorted`` is ``[E]``, non-decreasing, each relation's group
    starting on a 256-row boundary. ``precision``: ``"highest"`` (3xTF32)
    or ``"default"`` / ``None`` (one TF32 pass) for f32 data; bf16 data
    takes one bf16 pass whatever it says. ``runs``: the run table of
    ``rel_sorted``'s layout (``plan_runs`` of its SortPlan), trusted as
    it is; without it one launch of ``run_table`` builds it. CPU tensors take
    :func:`segment_outer_plain`, exact f32 at any precision; CUDA tensors
    launch the kernel (float32 or bfloat16 data, one dtype for both; int32
    ids; all contiguous) or raise. A forward-only launch:
    ``edge_transform_sorted``'s autograd Function calls it from its backward.
    """
    form = _common.matrix_form(x.dtype, precision)
    if x.device.type == "cpu":
        return segment_outer_plain(x, g, rel_sorted, num_rel)
    if x.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x.device}")
    _common.require_inference(_NAME, x, g)
    dev = x.device
    data = _common.F32_BF16
    _common.require_cuda(
        _NAME, dev, ("x", x, data), ("g", g, data),
        ("rel_sorted", rel_sorted, torch.int32),
    )
    dtype = _common.require_same_dtype(_NAME, x=x, g=g)
    e, d_in = x.shape
    if g.dim() != 2 or g.shape[0] != e or rel_sorted.shape != (e,):
        raise ValueError(
            f"{_NAME}: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"rel_sorted {tuple(rel_sorted.shape)} do not fit together"
        )
    d_out = g.shape[1]
    if runs is None:
        runs = run_table(rel_sorted, num_rel, RUN_TILES)
    else:
        require_runs(_NAME, runs, dev, num_rel)
    n_runs = max_runs(e, num_rel, runs.run_tiles)
    dw = torch.empty((num_rel, d_in, d_out), dtype=torch.float32, device=dev)
    partial = torch.empty((n_runs, d_in * d_out), dtype=torch.float32, device=dev)
    # One counter per relation, 64-column d_in slab and d_out slab (64
    # columns for d_out <= 64, else 128), as the kernel's grid has them.
    slabs = -(-d_in // 64) * (1 if d_out <= 64 else -(-d_out // 128))
    counters = _common.run_counters(dev, num_rel * slabs)
    lib = _lib()
    sizes = (e, d_in, d_out, num_rel, runs.run_tiles, n_runs)
    if form == "bf16":
        launch = lib.ghf_segment_outer_bf16
    else:
        launch = lib.ghf_segment_outer
        sizes += (_common.tf32_passes(precision),)
    ptrs = (x, g, runs.tile_splits, runs.run_splits, dw, partial, counters)
    with torch.cuda.device(dev):
        code = launch(
            *(_common.ptr(t) for t in ptrs), *sizes,
            _common.vec16(x, g, dw, partial, widths=(d_in, d_out), dtype=dtype),
            _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    _common.count_launch(_NAME, form)
    return dw
