"""Kernel 3: fused backward of the combined edge transform (``csrc/edge_transform_bwd.cu``).

Given the cotangent ``g [E, d_out]`` of kernel 2's output and its inputs,
returns ``dx_src = g @ W_msg[r]ᵀ``, ``dx_dst = g @ W_self[r]ᵀ`` and, for
every relation u, ``dW_msg[u] = Σ_{e: r=u} x_src[e]ᵀ g[e]`` and ``dW_self[u]``
likewise from ``x_dst``, with ``r = rel_sorted[(e // 256) * 256]``: each
256-row tile takes its relation from its first row (a ragged last tile
too). Relations that no tile visits, the bank's padding relations among
them, come out exactly zero. This is the function of the TPU kernel
``_combined_bwd_fused_impl``
(``graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368``).

On the card the kernel computes dx and one ``[2, d_in, d_out]`` dW partial
per run of up to :data:`RUN_TILES` consecutive tiles of one relation
(:func:`run_bounds`); kernel 1 (``csr_segment_sum``) then adds each
relation's partials over the run bounds, so one call of this wrapper
launches kernel 3 once and kernel 1 once, and the result is bitwise
deterministic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum

_NAME = "edge_transform_combined_bwd"

# Tiles of one relation that one kernel-3 block walks, keeping its dW in
# registers: 4 gives ~1,200 runs at the xl layout (E_pad = 1,031,680,
# U = 237), enough blocks for 132 SMs, and partials of 39 MB at d=64
# instead of 132 MB for one per tile.
RUN_TILES = 4


def as_tiles(t: torch.Tensor) -> torch.Tensor:
    """``[E, d]`` → ``[ceil(E / 256), 256, d]``, the ragged tail zero-padded."""
    e, d = t.shape
    tiles = -(-e // GROUP_PAD)
    pad = tiles * GROUP_PAD - e
    return torch.nn.functional.pad(t, (0, 0, 0, pad)).view(tiles, GROUP_PAD, d)


def rel_bounds(rel_sorted: torch.Tensor, num_rel: int) -> torch.Tensor:
    """``[num_rel + 1]`` int32 CSR bounds of the relation groups of
    non-decreasing ``rel_sorted``: relation u owns rows ``[bounds[u],
    bounds[u + 1])``, none for a relation that does not occur."""
    return torch.searchsorted(
        rel_sorted,
        torch.arange(num_rel + 1, dtype=rel_sorted.dtype, device=rel_sorted.device),
        out_int32=True,
    )


def tile_splits(rel_sorted: torch.Tensor, num_rel: int) -> torch.Tensor:
    """The :func:`rel_bounds` of the 256-row tiles: tile t belongs to
    relation ``rel_sorted[256 t]``."""
    return rel_bounds(rel_sorted[::GROUP_PAD].contiguous(), num_rel)


def run_bounds(
    rel_sorted: torch.Tensor, num_rel: int, run_tiles: int
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(tile_splits, run_splits, max_runs)`` of the runs of kernel 3.

    Relation u's tiles ``[tile_splits[u], tile_splits[u + 1])`` go in
    groups of ``run_tiles`` from the first, the last group ragged: its runs
    are ``run_splits[u] .. run_splits[u + 1] - 1`` (``[num_rel + 1]``
    int32, none for a relation with no tile). ``max_runs`` bounds the run
    count from the shapes alone, so that nothing is read back to the host.
    """
    t_splits = tile_splits(rel_sorted, num_rel)
    runs = torch.div(t_splits.diff() + (run_tiles - 1), run_tiles, rounding_mode="floor")
    r_splits = torch.zeros(num_rel + 1, dtype=torch.int32, device=rel_sorted.device)
    torch.cumsum(runs, 0, dtype=torch.int32, out=r_splits[1:])
    tiles = -(-rel_sorted.shape[0] // GROUP_PAD)
    return t_splits, r_splits, tiles // run_tiles + min(num_rel, tiles)


def edge_transform_combined_bwd_plain(
    g: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per-tile ``bmm`` with one gathered weight per
    tile, then the per-tile dW summed into its relation by ``index_add_``."""
    e, d_in = x_src.shape
    u = w_msg.shape[0]
    gt, xs, xd = as_tiles(g), as_tiles(x_src), as_tiles(x_dst)
    tile_rel = rel_sorted[::GROUP_PAD].long()
    dx_src = torch.bmm(gt, w_msg[tile_rel].transpose(1, 2)).reshape(-1, d_in)[:e]
    dx_dst = torch.bmm(gt, w_self[tile_rel].transpose(1, 2)).reshape(-1, d_in)[:e]
    part = torch.cat(
        [torch.bmm(xs.transpose(1, 2), gt), torch.bmm(xd.transpose(1, 2), gt)], dim=1
    )  # [tiles, 2 * d_in, d_out]
    dw = part.new_zeros((u,) + tuple(part.shape[1:])).index_add_(0, tile_rel, part)
    return dx_src, dx_dst, dw[:, :d_in], dw[:, d_in:]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_transform_bwd")
    fn = lib.ghf_edge_transform_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def edge_transform_combined_bwd(
    g: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx_src [E, d_in], dx_dst, dW_msg [U, d_in, d_out], dW_self)``.

    Args:
        g: ``[E, d_out]`` cotangent of the combined transform's output.
        x_src, x_dst: ``[E, d_in]`` the forward's gathered rows.
        rel_sorted: ``[E]`` relation ids, non-decreasing, each relation's
            group starting on a 256-row boundary.
        w_msg, w_self: ``[U, d_in, d_out]`` the forward's weight banks.

    CPU tensors take :func:`edge_transform_combined_bwd_plain`; CUDA
    tensors launch the kernel (float32 data, int32 ids, all contiguous) or
    raise. This is a forward-only launch: the combined transform's autograd
    Function calls it from its backward.
    """
    if g.device.type == "cpu":
        return edge_transform_combined_bwd_plain(g, x_src, x_dst, rel_sorted, w_msg, w_self)
    if g.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {g.device}")
    _common.require_inference(_NAME, g, x_src, x_dst, w_msg, w_self)
    dev = g.device
    f32 = torch.float32
    _common.require_cuda(
        _NAME, dev, ("g", g, f32), ("x_src", x_src, f32), ("x_dst", x_dst, f32),
        ("rel_sorted", rel_sorted, torch.int32), ("w_msg", w_msg, f32),
        ("w_self", w_self, f32),
    )
    e, d_in = x_src.shape
    u, _, d_out = w_msg.shape
    if (
        x_dst.shape != x_src.shape or g.shape != (e, d_out)
        or rel_sorted.shape != (e,) or w_msg.shape != (u, d_in, d_out)
        or w_self.shape != w_msg.shape
    ):
        raise ValueError(
            f"{_NAME}: shapes g {tuple(g.shape)}, x_src {tuple(x_src.shape)}, "
            f"x_dst {tuple(x_dst.shape)}, rel_sorted {tuple(rel_sorted.shape)}, "
            f"w_msg {tuple(w_msg.shape)}, w_self {tuple(w_self.shape)} do not "
            "fit together"
        )
    t_splits, r_splits, max_runs = run_bounds(rel_sorted, u, RUN_TILES)
    dx_src = torch.empty((e, d_in), dtype=f32, device=dev)
    dx_dst = torch.empty((e, d_in), dtype=f32, device=dev)
    partial = torch.empty((max_runs, 2 * d_in * d_out), dtype=f32, device=dev)
    floats = (g, x_src, x_dst, w_msg, w_self, dx_src, dx_dst, partial)
    with torch.cuda.device(dev):
        code = _lib().ghf_edge_transform_bwd(
            _common.ptr(g), _common.ptr(x_src), _common.ptr(x_dst),
            _common.ptr(t_splits), _common.ptr(r_splits),
            _common.ptr(w_msg), _common.ptr(w_self),
            _common.ptr(dx_src), _common.ptr(dx_dst), _common.ptr(partial),
            e, d_in, d_out, u, RUN_TILES, max_runs,
            _common.vec16(*floats, widths=(d_in, d_out)), _common.stream_of(dev),
        )
    _common.raise_on_error(_NAME, code)
    edge_transform_combined_bwd.launches += 1
    dw = csr_segment_sum(partial, r_splits, u).view(u, 2, d_in, d_out)
    return dx_src, dx_dst, dw[:, 0], dw[:, 1]


edge_transform_combined_bwd.launches = 0
