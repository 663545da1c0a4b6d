"""Kernel 2: relation-grouped combined edge transform (``csrc/edge_transform.cu``).

``out[e] = x_src[e] @ W_msg[r] + x_dst[e] @ W_self[r] + bias[r]`` with
``r = rel_sorted[(e // 256) * 256]``: the edge rows are relation-sorted and
group-padded, so each 256-row tile holds one relation and takes it from
its first row (a ragged last tile too). This is the function of the TPU
kernel ``edge_transform_sorted_combined``
(``graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239``).

:func:`edge_transform_sorted_combined` is differentiable through a
``torch.autograd.Function`` with the JAX package's VJP (``_combined_bwd``,
same file :277-315): kernel 3 (``ops/cuda/edge_transform_bwd.py``) gives
``dx_src``, ``dx_dst``, ``dW_msg`` and ``dW_self`` in one pass, and ``dbias``
is the segment-sum of ``g`` over ``rel_splits`` (kernel 1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    edge_transform_combined_bwd,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum

_NAME = "edge_transform_sorted_combined"


def edge_transform_sorted_combined_plain(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: one ``bmm`` per bank over 256-row tiles.

    Gathers one ``[d_in, d_out]`` weight per tile, never per edge.
    """
    e, d_in = x_src.shape
    d_out = w_msg.shape[-1]
    tiles = -(-e // GROUP_PAD)
    pad = tiles * GROUP_PAD - e
    xs = torch.nn.functional.pad(x_src, (0, 0, 0, pad)).view(tiles, GROUP_PAD, d_in)
    xd = torch.nn.functional.pad(x_dst, (0, 0, 0, pad)).view(tiles, GROUP_PAD, d_in)
    tile_rel = rel_sorted[::GROUP_PAD].long()
    out = torch.bmm(xs, w_msg[tile_rel]) + torch.bmm(xd, w_self[tile_rel])
    out = out + bias[tile_rel][:, None, :]
    return out.reshape(tiles * GROUP_PAD, d_out)[:e]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_transform")
    fn = lib.ghf_edge_transform
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x_src, x_dst, rel_sorted, w_msg, w_self, bias) -> torch.Tensor:
    """Kernel 2 on CUDA tensors, the plain version on CPU tensors."""
    if x_src.device.type == "cpu":
        return edge_transform_sorted_combined_plain(
            x_src, x_dst, rel_sorted, w_msg, w_self, bias
        )
    if x_src.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x_src.device}")
    _common.require_inference(_NAME, x_src, x_dst, w_msg, w_self, bias)
    dev = x_src.device
    f32 = torch.float32
    _common.require_cuda(
        _NAME, dev, ("x_src", x_src, f32), ("x_dst", x_dst, f32),
        ("rel_sorted", rel_sorted, torch.int32), ("w_msg", w_msg, f32),
        ("w_self", w_self, f32), ("bias", bias, f32),
    )
    e, d_in = x_src.shape
    u, _, d_out = w_msg.shape
    if (
        x_dst.shape != x_src.shape or rel_sorted.shape != (e,)
        or w_msg.shape != (u, d_in, d_out) or w_self.shape != w_msg.shape
        or bias.shape != (u, d_out)
    ):
        raise ValueError(
            f"{_NAME}: shapes x_src {tuple(x_src.shape)}, x_dst "
            f"{tuple(x_dst.shape)}, rel_sorted {tuple(rel_sorted.shape)}, "
            f"w_msg {tuple(w_msg.shape)}, w_self {tuple(w_self.shape)}, "
            f"bias {tuple(bias.shape)} do not fit together"
        )
    out = torch.empty((e, d_out), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().ghf_edge_transform(
            _common.ptr(x_src), _common.ptr(x_dst), _common.ptr(rel_sorted),
            _common.ptr(w_msg), _common.ptr(w_self), _common.ptr(bias),
            _common.ptr(out), e, d_in, d_out, _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    edge_transform_sorted_combined.launches += 1
    return out


class _EdgeTransformSortedCombined(torch.autograd.Function):
    """Kernel 2 forward; kernel 3 plus the ``dbias`` segment-sum backward."""

    @staticmethod
    def forward(ctx, x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits):
        # The residuals of the JAX VJP: both gathered streams and the banks.
        ctx.save_for_backward(x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits)
        return _launch(x_src, x_dst, rel_sorted, w_msg, w_self, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits = ctx.saved_tensors
        g = g.contiguous()
        dx_src, dx_dst, dw_msg, dw_self = edge_transform_combined_bwd(
            g, x_src, x_dst, rel_sorted, w_msg, w_self
        )
        u = w_msg.shape[0]
        if rel_splits is not None:
            dbias = csr_segment_sum(g, rel_splits, u)
        else:
            dbias = g.new_zeros((u, g.shape[1])).index_add_(0, rel_sorted, g)
        return dx_src, dx_dst, None, dw_msg, dw_self, dbias, None


def edge_transform_sorted_combined(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    rel_splits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-edge ``msg + self`` contribution over single-relation tiles → ``[E, d_out]``.

    Args:
        x_src, x_dst: ``[E, d_in]`` gathered source / destination rows.
        rel_sorted: ``[E]`` relation ids, non-decreasing, each relation's
            group starting on a 256-row boundary.
        w_msg, w_self: ``[U, d_in, d_out]`` weight banks; bias ``[U, d_out]``.
        rel_splits: optional ``[U + 1]`` int32 CSR bounds of the relation
            groups (``SortPlan.rel_splits``); the backward then reduces
            ``dbias`` through kernel 1 instead of ``index_add_``.

    Differentiable in every float input. CPU tensors take
    :func:`edge_transform_sorted_combined_plain` (and kernel 3's plain
    version in the backward); CUDA tensors launch the kernels (float32
    data, int32 ids, all contiguous) or raise.
    """
    return _EdgeTransformSortedCombined.apply(
        x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits
    )


edge_transform_sorted_combined.launches = 0
