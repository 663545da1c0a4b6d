"""Kernels 2 and 5: relation-grouped edge transforms (``csrc/edge_transform.cu``).

The edge rows are relation-sorted and group-padded, so each 256-row tile
holds one relation and takes it from its first row (a ragged last tile
too): ``r = rel_sorted[(e // 256) * 256]``.

Kernel 2, :func:`edge_transform_sorted_combined`: ``out[e] = x_src[e] @
W_msg[r] + x_dst[e] @ W_self[r] + bias[r]``, the function of the TPU kernel
``edge_transform_sorted_combined``
(``graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239``). Its
autograd Function has the JAX package's VJP (``_combined_bwd``, same file
:277-315): kernel 3 (``ops/cuda/edge_transform_bwd.py``) gives ``dx_src``,
``dx_dst``, ``dW_msg`` and ``dW_self`` in one pass, and ``dbias`` is the
segment-sum of ``g`` over ``rel_splits`` (kernel 1).

Kernel 5, :func:`edge_transform_sorted`: the two streams apart, ``msg[e] =
x_src[e] @ W_msg[r] + bias[r]`` and ``selfc[e] = x_dst[e] @ W_self[r]``, the
function of the TPU kernel of ``edge_transform_sorted``
(``_edge_transform_fwd_impl``, same file :108), launched as a mode of
kernel 2's body with one grid plane per output. Its autograd Function has
that entry point's VJP (``_bwd``, :569-607): kernel 5 again on the two
cotangents with the banks transposed and a zero bias for ``dx_src`` and
``dx_dst``, kernel 6 (``ops/cuda/segment_outer.py``) for each ``dW``, and
kernel 1 for ``dbias``. :func:`edge_contributions_cuda_sorted` is the entry
point of the JAX package's ``edge_contributions_pallas_sorted`` (:618).
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
    edge_transform_combined_bwd,
    rel_bounds,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer import segment_outer
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum

_NAME = "edge_transform_sorted_combined"
_NAME_TWO = "edge_transform_sorted"


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
    e = x_src.shape[0]
    d_out = w_msg.shape[-1]
    tile_rel = rel_sorted[::GROUP_PAD].long()
    out = torch.bmm(as_tiles(x_src), w_msg[tile_rel]) + torch.bmm(
        as_tiles(x_dst), w_self[tile_rel]
    )
    out = out + bias[tile_rel][:, None, :]
    return out.reshape(-1, d_out)[:e]


def edge_transform_sorted_plain(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5: ``(msg, selfc)``, one ``bmm`` per
    bank over 256-row tiles, one weight gathered per tile."""
    e = x_src.shape[0]
    d_out = w_msg.shape[-1]
    tile_rel = rel_sorted[::GROUP_PAD].long()
    msg = torch.baddbmm(bias[tile_rel][:, None, :], as_tiles(x_src), w_msg[tile_rel])
    selfc = torch.bmm(as_tiles(x_dst), w_self[tile_rel])
    return msg.reshape(-1, d_out)[:e], selfc.reshape(-1, d_out)[:e]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_transform")
    fn = lib.ghf_edge_transform
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    two = lib.ghf_edge_transform_two
    two.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    two.restype = ctypes.c_int
    return lib


def _check(name, x_src, x_dst, rel_sorted, w_msg, w_self, bias):
    """The launch checks of kernels 2 and 5 → ``(E, d_in, d_out)``."""
    _common.require_inference(name, x_src, x_dst, w_msg, w_self, bias)
    f32 = torch.float32
    _common.require_cuda(
        name, x_src.device, ("x_src", x_src, f32), ("x_dst", x_dst, f32),
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
            f"{name}: shapes x_src {tuple(x_src.shape)}, x_dst "
            f"{tuple(x_dst.shape)}, rel_sorted {tuple(rel_sorted.shape)}, "
            f"w_msg {tuple(w_msg.shape)}, w_self {tuple(w_self.shape)}, "
            f"bias {tuple(bias.shape)} do not fit together"
        )
    return e, d_in, d_out


def _launch(two: bool, x_src, x_dst, rel_sorted, w_msg, w_self, bias):
    """Kernel 5 (``two``: ``(msg, selfc)``) or kernel 2 (one summed output)
    on CUDA tensors, the matching plain version on CPU tensors."""
    name = _NAME_TWO if two else _NAME
    args = (x_src, x_dst, rel_sorted, w_msg, w_self, bias)
    if x_src.device.type == "cpu":
        plain = edge_transform_sorted_plain if two else edge_transform_sorted_combined_plain
        return plain(*args)
    if x_src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_src.device}")
    e, d_in, d_out = _check(name, *args)
    dev = x_src.device
    outs = [
        torch.empty((e, d_out), dtype=torch.float32, device=dev)
        for _ in range(2 if two else 1)
    ]
    lib = _lib()
    launch = lib.ghf_edge_transform_two if two else lib.ghf_edge_transform
    ptrs = [_common.ptr(t) for t in (*args, *outs)]
    vec = _common.vec16(*args, *outs, widths=(d_in, d_out))
    with torch.cuda.device(dev):
        code = launch(*ptrs, e, d_in, d_out, vec, _common.stream_of(dev))
    _common.raise_on_error(name, code)
    if two:
        edge_transform_sorted.launches += 1
        return tuple(outs)
    edge_transform_sorted_combined.launches += 1
    return outs[0]


class _EdgeTransformSortedCombined(torch.autograd.Function):
    """Kernel 2 forward; kernel 3 plus the ``dbias`` segment-sum backward."""

    @staticmethod
    def forward(ctx, x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits):
        # The residuals of the JAX VJP: both gathered streams and the banks.
        ctx.save_for_backward(x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits)
        return _launch(False, x_src, x_dst, rel_sorted, w_msg, w_self, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits = ctx.saved_tensors
        g = g.contiguous()
        dx_src, dx_dst, dw_msg, dw_self = edge_transform_combined_bwd(
            g, x_src, x_dst, rel_sorted, w_msg, w_self
        )
        u = w_msg.shape[0]
        if rel_splits is None:
            rel_splits = rel_bounds(rel_sorted, u)
        dbias = csr_segment_sum(g, rel_splits, u)
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
            groups (``SortPlan.rel_splits``) over which the backward reduces
            ``dbias`` through kernel 1; without them it searches
            ``rel_sorted`` for the bounds (:func:`rel_bounds`).

    Differentiable in every float input. CPU tensors take
    :func:`edge_transform_sorted_combined_plain` (and kernel 3's plain
    version in the backward); CUDA tensors launch the kernels (float32
    data, int32 ids, all contiguous) or raise.
    """
    return _EdgeTransformSortedCombined.apply(
        x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits
    )


edge_transform_sorted_combined.launches = 0


class _EdgeTransformSorted(torch.autograd.Function):
    """Kernel 5 forward; kernel 5 on the cotangents with transposed banks,
    kernel 6 twice and the ``dbias`` segment-sum backward."""

    @staticmethod
    def forward(ctx, x_src, x_dst, rel_sorted, w_msg, w_self, bias):
        ctx.save_for_backward(x_src, x_dst, rel_sorted, w_msg, w_self)
        return _launch(True, x_src, x_dst, rel_sorted, w_msg, w_self, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_msg, g_selfc):
        x_src, x_dst, rel_sorted, w_msg, w_self = ctx.saved_tensors
        g_msg, g_selfc = g_msg.contiguous(), g_selfc.contiguous()
        u, d_in = w_msg.shape[:2]
        # dx through the forward kernel: the banks transposed to
        # [U, d_out, d_in] and a zero bias, as the JAX VJP does (:579-592).
        dx_src, dx_dst = _launch(
            True, g_msg, g_selfc, rel_sorted,
            w_msg.transpose(1, 2).contiguous(), w_self.transpose(1, 2).contiguous(),
            g_msg.new_zeros((u, d_in)),
        )
        dw_msg = segment_outer(x_src, g_msg, rel_sorted, u)
        dw_self = segment_outer(x_dst, g_selfc, rel_sorted, u)
        dbias = csr_segment_sum(g_msg, rel_bounds(rel_sorted, u), u)
        return dx_src, dx_dst, None, dw_msg, dw_self, dbias


def edge_transform_sorted(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge ``(msg, selfc)`` over single-relation tiles, ``[E, d_out]`` each.

    Args:
        x_src, x_dst: ``[E, d_in]`` gathered source / destination rows.
        rel_sorted: ``[E]`` relation ids, non-decreasing, each relation's
            group starting on a 256-row boundary.
        w_msg, w_self: ``[U, d_in, d_out]`` weight banks; bias ``[U, d_out]``.

    Differentiable in every float input. CPU tensors take
    :func:`edge_transform_sorted_plain` (and the plain versions of kernels
    6 and 1 in the backward); CUDA tensors launch the kernels (float32
    data, int32 ids, all contiguous) or raise.
    """
    return _EdgeTransformSorted.apply(x_src, x_dst, rel_sorted, w_msg, w_self, bias)


edge_transform_sorted.launches = 0


def edge_contributions_cuda_sorted(
    h: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    *,
    sort_plan=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge ``(msg, selfc)`` of one layer on the group-padded sorted
    layout (``encode_graph(sort_by_relation=True, group_pad=256)``): the
    two streams the message-passing tail
    (``ops.message_passing.two_stream_tail``) reduces.

    With a :class:`~graph_hypernetwork_forge_tpu_torch.data.encoding.SortPlan`
    (tensors on ``h``'s device) the ``h[src]``, ``h[dst]`` gathers reduce
    their cotangents through the plan's permutations and kernel 1
    (``take_rows_pair``); without one they are plain gathers. Then kernel 5
    (:func:`edge_transform_sorted`).
    """
    # ops.segment imports kernel 1 from this package; imported here so that
    # the two packages do not import each other at load time.
    from graph_hypernetwork_forge_tpu_torch.ops.segment import take_rows_pair

    if sort_plan is not None:
        p = sort_plan
        x_src, x_dst = take_rows_pair(
            h, src, dst, p.src_perm, p.src_sorted, p.src_splits,
            p.dst_perm, p.dst_sorted, p.dst_splits,
        )
    else:
        x_src, x_dst = h.index_select(0, src), h.index_select(0, dst)
    return edge_transform_sorted(x_src, x_dst, rel_ids, w_msg, w_self, bias)

