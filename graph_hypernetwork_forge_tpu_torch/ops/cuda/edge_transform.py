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
segment-sum of ``g`` over ``rel_splits`` (kernel 1). It takes bf16 data
(speed mode: bf16 products summed in f32, the output rounded once to bf16)
and, for f32 data, ``precision="default"`` (one TF32 pass instead of
3xTF32), as the TPU kernel's ``precision`` and bf16 branch.

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
Kernel 5 takes the forms of kernel 2, bf16 data and ``precision``, and its
backward launches kernels 5 and 6 in the forward's form.
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
    plan_runs,
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

    Gathers one ``[d_in, d_out]`` weight per tile, never per edge. bf16
    operands are upcast and multiplied in f32 (bf16 products are exact in
    f32) and the result rounded once to bf16, the kernel's bf16 form.
    """
    dtype = x_src.dtype
    if dtype == torch.bfloat16:
        x_src, x_dst, w_msg, w_self, bias = (
            t.float() for t in (x_src, x_dst, w_msg, w_self, bias)
        )
    e = x_src.shape[0]
    d_out = w_msg.shape[-1]
    tile_rel = rel_sorted[::GROUP_PAD].long()
    out = torch.bmm(as_tiles(x_src), w_msg[tile_rel]) + torch.bmm(
        as_tiles(x_dst), w_self[tile_rel]
    )
    out = out + bias[tile_rel][:, None, :]
    return out.reshape(-1, d_out)[:e].to(dtype)


def edge_transform_sorted_plain(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5: ``(msg, selfc)``, one ``bmm`` per
    bank over 256-row tiles, one weight gathered per tile. bf16 operands are
    upcast and multiplied in f32, and each output rounded once to bf16
    (``msg`` after the bias is added), the kernel's bf16 form."""
    dtype = x_src.dtype
    if dtype == torch.bfloat16:
        x_src, x_dst, w_msg, w_self, bias = (
            t.float() for t in (x_src, x_dst, w_msg, w_self, bias)
        )
    e = x_src.shape[0]
    d_out = w_msg.shape[-1]
    tile_rel = rel_sorted[::GROUP_PAD].long()
    msg = torch.baddbmm(bias[tile_rel][:, None, :], as_tiles(x_src), w_msg[tile_rel])
    selfc = torch.bmm(as_tiles(x_dst), w_self[tile_rel])
    return msg.reshape(-1, d_out)[:e].to(dtype), selfc.reshape(-1, d_out)[:e].to(dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_transform")
    fn = lib.ghf_edge_transform
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = lib.ghf_edge_transform_bf16
    bf16.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bf16.restype = ctypes.c_int
    two = lib.ghf_edge_transform_two
    two.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    two.restype = ctypes.c_int
    two_bf16 = lib.ghf_edge_transform_two_bf16
    two_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    two_bf16.restype = ctypes.c_int
    return lib


def _check(name, dtypes, x_src, x_dst, rel_sorted, w_msg, w_self, bias):
    """The launch checks of kernels 2 and 5 → ``(E, d_in, d_out)``."""
    _common.require_inference(name, x_src, x_dst, w_msg, w_self, bias)
    _common.require_cuda(
        name, x_src.device, ("x_src", x_src, dtypes), ("x_dst", x_dst, dtypes),
        ("rel_sorted", rel_sorted, torch.int32), ("w_msg", w_msg, dtypes),
        ("w_self", w_self, dtypes), ("bias", bias, dtypes),
    )
    _common.require_same_dtype(name, x_src=x_src, x_dst=x_dst, w_msg=w_msg,
                               w_self=w_self, bias=bias)
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


def _launch(two: bool, x_src, x_dst, rel_sorted, w_msg, w_self, bias,
            precision="highest"):
    """Kernel 5 (``two``: ``(msg, selfc)``) or kernel 2 (one summed output),
    in the form of the data and ``precision``, on CUDA tensors; the matching
    plain version on CPU tensors."""
    name = _NAME_TWO if two else _NAME
    args = (x_src, x_dst, rel_sorted, w_msg, w_self, bias)
    form = _common.matrix_form(x_src.dtype, precision)
    if x_src.device.type == "cpu":
        plain = edge_transform_sorted_plain if two else edge_transform_sorted_combined_plain
        return plain(*args)
    if x_src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_src.device}")
    e, d_in, d_out = _check(name, _common.F32_BF16, *args)
    dev, dtype = x_src.device, x_src.dtype
    outs = [
        torch.empty((e, d_out), dtype=dtype, device=dev)
        for _ in range(2 if two else 1)
    ]
    lib = _lib()
    ptrs = [_common.ptr(t) for t in (*args, *outs)]
    vec = _common.vec16(*args, *outs, widths=(d_in, d_out), dtype=dtype)
    sizes = (e, d_in, d_out)
    if form == "bf16":
        launch = lib.ghf_edge_transform_two_bf16 if two else lib.ghf_edge_transform_bf16
    else:
        launch = lib.ghf_edge_transform_two if two else lib.ghf_edge_transform
        sizes += (_common.tf32_passes(precision),)
    with torch.cuda.device(dev):
        code = launch(*ptrs, *sizes, vec, _common.stream_of(dev))
    _common.raise_on_error(name, code)
    _common.count_launch(name, form)
    return tuple(outs) if two else outs[0]


class _EdgeTransformSortedCombined(torch.autograd.Function):
    """Kernel 2 forward; kernel 3 plus the ``dbias`` segment-sum backward."""

    @staticmethod
    def forward(ctx, x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits,
                precision, runs):
        # The residuals of the JAX VJP: both gathered streams and the banks.
        ctx.save_for_backward(x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits)
        ctx.precision, ctx.bias_dtype, ctx.runs = precision, bias.dtype, runs
        return _launch(False, x_src, x_dst, rel_sorted, w_msg, w_self, bias,
                       precision)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits = ctx.saved_tensors
        g = g.contiguous()
        dx_src, dx_dst, dw_msg, dw_self = edge_transform_combined_bwd(
            g, x_src, x_dst, rel_sorted, w_msg, w_self, precision=ctx.precision,
            runs=ctx.runs,
        )
        u = w_msg.shape[0]
        if rel_splits is None:
            rel_splits = rel_bounds(rel_sorted, u)
        # dW and dbias are summed in f32 and cast to their parameters' dtype
        # (JAX _combined_bwd :293-294, :308).
        dbias = csr_segment_sum(g, rel_splits, u).to(ctx.bias_dtype)
        return (dx_src, dx_dst, None, dw_msg.to(w_msg.dtype),
                dw_self.to(w_self.dtype), dbias, None, None, None)


def edge_transform_sorted_combined(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    rel_splits: torch.Tensor | None = None,
    precision="highest",
    runs=None,
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
        precision: ``"highest"`` (3xTF32, f32-class) or ``"default"`` /
            ``None`` (one TF32 pass) for the products of f32 data, forward
            and backward; bf16 data takes one bf16 pass whatever it says.
        runs: optional ``RunTable`` of the layout for kernel 3
            (``edge_transform_bwd.plan_runs(sort_plan)``), built on the host
            with the SortPlan; without it the backward builds one per call.

    Differentiable in every float input. The output has the data's dtype;
    dW and dbias are summed in f32 and cast to their parameters' dtype. CPU
    tensors take :func:`edge_transform_sorted_combined_plain` (and kernel
    3's plain version in the backward), exact f32 at any precision; CUDA
    tensors launch the kernels (float32 or bfloat16 data, one dtype for
    all, int32 ids, all contiguous) or raise.
    """
    return _EdgeTransformSortedCombined.apply(
        x_src, x_dst, rel_sorted, w_msg, w_self, bias, rel_splits, precision, runs
    )


class _EdgeTransformSorted(torch.autograd.Function):
    """Kernel 5 forward; kernel 5 on the cotangents with transposed banks,
    kernel 6 twice and the ``dbias`` segment-sum backward."""

    @staticmethod
    def forward(ctx, x_src, x_dst, rel_sorted, w_msg, w_self, bias, precision,
                rel_splits, runs):
        ctx.save_for_backward(x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits)
        ctx.precision, ctx.bias_dtype, ctx.runs = precision, bias.dtype, runs
        return _launch(True, x_src, x_dst, rel_sorted, w_msg, w_self, bias, precision)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_msg, g_selfc):
        x_src, x_dst, rel_sorted, w_msg, w_self, rel_splits = ctx.saved_tensors
        g_msg, g_selfc = g_msg.contiguous(), g_selfc.contiguous()
        u, d_in = w_msg.shape[:2]
        # dx through the forward kernel: the banks transposed to
        # [U, d_out, d_in] and a zero bias, as the JAX VJP does (:579-592).
        dx_src, dx_dst = _launch(
            True, g_msg, g_selfc, rel_sorted,
            w_msg.transpose(1, 2).contiguous(), w_self.transpose(1, 2).contiguous(),
            g_msg.new_zeros((u, d_in)), ctx.precision,
        )
        # dW and dbias are summed in f32 and cast to their parameters' dtype
        # (JAX _bwd :593-606).
        dw_msg = segment_outer(x_src, g_msg, rel_sorted, u, ctx.precision, ctx.runs)
        dw_self = segment_outer(x_dst, g_selfc, rel_sorted, u, ctx.precision, ctx.runs)
        if rel_splits is None:
            rel_splits = rel_bounds(rel_sorted, u)
        dbias = csr_segment_sum(g_msg, rel_splits, u)
        return (dx_src, dx_dst, None, dw_msg.to(w_msg.dtype), dw_self.to(w_self.dtype),
                dbias.to(ctx.bias_dtype), None, None, None)


def edge_transform_sorted(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    precision="highest",
    rel_splits: torch.Tensor | None = None,
    runs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge ``(msg, selfc)`` over single-relation tiles, ``[E, d_out]`` each.

    Args:
        x_src, x_dst: ``[E, d_in]`` gathered source / destination rows.
        rel_sorted: ``[E]`` relation ids, non-decreasing, each relation's
            group starting on a 256-row boundary.
        w_msg, w_self: ``[U, d_in, d_out]`` weight banks; bias ``[U, d_out]``.
        precision: ``"highest"`` (3xTF32, f32-class) or ``"default"`` /
            ``None`` (one TF32 pass) for the products of f32 data, forward
            and backward; bf16 data takes one bf16 pass whatever it says.
        rel_splits: optional ``[U + 1]`` int32 CSR bounds of the relation
            groups (``SortPlan.rel_splits``) for the backward's ``dbias``;
            without them it searches ``rel_sorted``.
        runs: optional ``RunTable`` of the layout
            (``edge_transform_bwd.plan_runs(sort_plan)``), handed to both
            kernel 6 calls of the backward; without it each builds one.

    Differentiable in every float input. The outputs have the data's dtype;
    dW and dbias are summed in f32 and cast to their parameters' dtype. CPU
    tensors take :func:`edge_transform_sorted_plain` (and the plain
    versions of kernels 6 and 1 in the backward), exact f32 at any
    precision; CUDA tensors launch the kernels (float32 or bfloat16 data,
    one dtype for all, int32 ids, all contiguous) or raise.
    """
    return _EdgeTransformSorted.apply(
        x_src, x_dst, rel_sorted, w_msg, w_self, bias, precision, rel_splits, runs
    )


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
    precision="highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge ``(msg, selfc)`` of one layer on the group-padded sorted
    layout (``encode_graph(sort_by_relation=True, group_pad=256)``): the
    two streams the message-passing tail
    (``ops.message_passing.two_stream_tail``) reduces.

    With a :class:`~graph_hypernetwork_forge_tpu_torch.data.encoding.SortPlan`
    (tensors on ``h``'s device) the ``h[src]``, ``h[dst]`` gathers reduce
    their cotangents through the plan's permutations and kernel 1
    (``take_rows_pair``) and the backward takes the plan's relation bounds
    and kernel 6's run table; without one they are plain gathers. Then
    kernel 5 (:func:`edge_transform_sorted`) at ``precision``. Speed mode is
    the caller's, as in JAX: bf16 ``h``, banks and bias give bf16 streams.
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
        rel_splits = p.rel_splits
    else:
        x_src, x_dst = h.index_select(0, src), h.index_select(0, dst)
        rel_splits = None
    return edge_transform_sorted(x_src, x_dst, rel_ids, w_msg, w_self, bias, precision,
                                 rel_splits, plan_runs(sort_plan))

