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

On the card one launch of kernel 3 computes dx and dW: each block walks a
run of up to ``run_tiles`` consecutive tiles of one relation (a
:class:`RunTable`), and the relation's runs add their f32 dW partials
inside the kernel, in run order, in the block that finishes last (an
ordered last-arriver reduction, ``csrc/run_reduce.cuh``): bitwise
deterministic, no float atomics, no second launch. The run table comes
from the caller's SortPlan, built on the host once per layout
(``SortPlan.tile_splits`` and ``run_splits``, :func:`plan_runs`), or,
without one, from one launch of a small kernel per call (:func:`run_table`).
Kernel 3 takes bf16 data at any d_out (speed mode: dx rounded once to bf16
from its f32 sum, dW summed in f32) and, for f32 data,
``precision="default"`` (one TF32 pass).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD, RUN_TILES
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.build import load

_NAME = "edge_transform_combined_bwd"

@dataclasses.dataclass(frozen=True)
class RunTable:
    """The runs of kernels 3 and 6 over one relation-sorted layout.

    Relation u's 256-row tiles ``[tile_splits[u], tile_splits[u + 1])`` go
    in runs of ``run_tiles`` from the first, the last one ragged, numbered
    ``run_splits[u] .. run_splits[u + 1] - 1``; both are ``[U + 1]`` int32
    on the kernel's device.
    """

    tile_splits: torch.Tensor
    run_splits: torch.Tensor
    run_tiles: int


def plan_runs(plan) -> RunTable | None:
    """The run table of kernels 3 and 6 that a SortPlan carries (runs of
    ``RUN_TILES`` tiles, ``data/encoding.py``), built on the host with the
    plan and on the plan's device after ``SortPlan.to``; None without a
    plan."""
    if plan is None or plan.tile_splits is None:
        return None
    return RunTable(plan.tile_splits, plan.run_splits, RUN_TILES)


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
    """``(tile_splits, run_splits, max_runs)`` of the runs of kernels 3 and
    6, in PyTorch: the reference of the run tables that the SortPlan and
    :func:`run_table` build.

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
    return t_splits, r_splits, max_runs(rel_sorted.shape[0], num_rel, run_tiles)


def max_runs(num_edges: int, num_rel: int, run_tiles: int) -> int:
    """An upper bound of the runs of ``num_edges`` rows and ``num_rel``
    relations, from the shapes alone: each relation's ragged run, and one
    run per ``run_tiles`` tiles besides."""
    tiles = -(-num_edges // GROUP_PAD)
    return tiles // run_tiles + min(num_rel, tiles)


def run_table(rel_sorted: torch.Tensor, num_rel: int, run_tiles: int) -> RunTable:
    """The :class:`RunTable` of ``rel_sorted`` (non-decreasing, on a 256-row
    tile layout) built on its device: one launch of the run-table kernel of
    ``csrc/edge_transform_bwd.cu`` on a CUDA tensor, counted as
    ``kernel.run_table``; :func:`run_bounds` on a CPU tensor. Kernels 3
    and 6 call it per call (runs of ``RUN_TILES`` tiles) only where no
    SortPlan hands its table down."""
    if rel_sorted.device.type == "cpu":
        t_splits, r_splits, _ = run_bounds(rel_sorted, num_rel, run_tiles)
        return RunTable(t_splits, r_splits, run_tiles)
    dev = rel_sorted.device
    _common.require_cuda("run_table", dev, ("rel_sorted", rel_sorted, torch.int32))
    t_splits = torch.empty(num_rel + 1, dtype=torch.int32, device=dev)
    r_splits = torch.empty(num_rel + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().ghf_run_table(
            _common.ptr(rel_sorted), rel_sorted.shape[0], num_rel, run_tiles,
            _common.ptr(t_splits), _common.ptr(r_splits), _common.stream_of(dev))
    _common.raise_on_error("run_table", code)
    _common.count_launch("run_table")
    return RunTable(t_splits, r_splits, run_tiles)


def require_runs(kernel: str, runs: RunTable, device: torch.device, num_rel: int) -> None:
    """A handed-down run table lies on ``device`` and has ``num_rel + 1``
    int32 bounds of each kind."""
    _common.require_cuda(kernel, device, ("tile_splits", runs.tile_splits, torch.int32),
                         ("run_splits", runs.run_splits, torch.int32))
    if runs.tile_splits.shape != (num_rel + 1,) or runs.run_splits.shape != (num_rel + 1,):
        raise ValueError(
            f"{kernel}: the run table has {tuple(runs.tile_splits.shape)} tile and "
            f"{tuple(runs.run_splits.shape)} run bounds; expected ({num_rel + 1},)"
        )


def edge_transform_combined_bwd_plain(
    g: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per-tile ``bmm`` with one gathered weight per
    tile, then the per-tile dW summed into its relation by ``index_add_``.

    bf16 data is upcast and multiplied in f32; dx is rounded once to g's
    dtype and dW stays f32, the kernel's bf16 form.
    """
    dtype = g.dtype
    if dtype == torch.bfloat16:
        g, x_src, x_dst, w_msg, w_self = (
            t.float() for t in (g, x_src, x_dst, w_msg, w_self)
        )
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
    return dx_src.to(dtype), dx_dst.to(dtype), dw[:, :d_in], dw[:, d_in:]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_transform_bwd")
    fn = lib.ghf_edge_transform_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = lib.ghf_edge_transform_bwd_bf16
    bf16.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bf16.restype = ctypes.c_int
    table = lib.ghf_run_table
    table.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    table.restype = ctypes.c_int
    return lib


def edge_transform_combined_bwd(
    g: torch.Tensor,
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    rel_sorted: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    precision="highest",
    runs: RunTable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx_src [E, d_in], dx_dst, dW_msg [U, d_in, d_out], dW_self)``.

    Args:
        g: ``[E, d_out]`` cotangent of the combined transform's output.
        x_src, x_dst: ``[E, d_in]`` the forward's gathered rows.
        rel_sorted: ``[E]`` relation ids, non-decreasing, each relation's
            group starting on a 256-row boundary.
        w_msg, w_self: ``[U, d_in, d_out]`` the forward's weight banks.
        precision: ``"highest"`` (3xTF32) or ``"default"`` / ``None`` (one
            TF32 pass) for f32 data; bf16 data takes one bf16 pass.
        runs: the run table of ``rel_sorted``'s layout (:func:`plan_runs`
            of its SortPlan), trusted as it is; without it one launch of
            :func:`run_table` builds it.

    dx has g's dtype; dW is f32. CPU tensors take
    :func:`edge_transform_combined_bwd_plain`; CUDA tensors launch the
    kernel (float32 or bfloat16 data, one dtype for all, any widths; int32
    ids; all contiguous) or raise. This is a forward-only launch: the
    combined transform's autograd Function calls it from its backward.
    """
    form = _common.matrix_form(g.dtype, precision)
    if g.device.type == "cpu":
        return edge_transform_combined_bwd_plain(g, x_src, x_dst, rel_sorted, w_msg, w_self)
    if g.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {g.device}")
    _common.require_inference(_NAME, g, x_src, x_dst, w_msg, w_self)
    dev = g.device
    f32, data = torch.float32, _common.F32_BF16
    _common.require_cuda(
        _NAME, dev, ("g", g, data), ("x_src", x_src, data), ("x_dst", x_dst, data),
        ("rel_sorted", rel_sorted, torch.int32), ("w_msg", w_msg, data),
        ("w_self", w_self, data),
    )
    dtype = _common.require_same_dtype(
        _NAME, g=g, x_src=x_src, x_dst=x_dst, w_msg=w_msg, w_self=w_self
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
    if runs is None:
        runs = run_table(rel_sorted, u, RUN_TILES)
    else:
        require_runs(_NAME, runs, dev, u)
    n_runs = max_runs(e, u, runs.run_tiles)
    dx_src = torch.empty((e, d_in), dtype=dtype, device=dev)
    dx_dst = torch.empty((e, d_in), dtype=dtype, device=dev)
    dw = torch.empty((2, u, d_in, d_out), dtype=f32, device=dev)
    partial = torch.empty((n_runs, 2 * d_in * d_out), dtype=f32, device=dev)
    counters = _common.run_counters(dev, u * -(-d_in // 64))
    # bf16 at d_out > 128: dx's f32 sums over the 128-column slabs before
    # the last, rounded once on the last.
    dx_acc = (torch.empty((2, e, d_in), dtype=f32, device=dev)
              if form == "bf16" and d_out > 128 else None)
    outs = (dx_src, dx_dst) + ((dx_acc,) if form == "bf16" else ())
    data_ptrs = (g, x_src, x_dst, runs.tile_splits, runs.run_splits, w_msg, w_self,
                 *outs, dw[0], dw[1], partial, counters)
    sizes = (e, d_in, d_out, u, runs.run_tiles, n_runs)
    vec = _common.vec16(g, x_src, x_dst, w_msg, w_self, dx_src, dx_dst, dw, partial,
                        *(() if dx_acc is None else (dx_acc,)),
                        widths=(d_in, d_out), dtype=dtype)
    lib = _lib()
    if form == "bf16":
        launch = lib.ghf_edge_transform_bwd_bf16
    else:
        launch = lib.ghf_edge_transform_bwd
        sizes += (_common.tf32_passes(precision),)
    with torch.cuda.device(dev):
        code = launch(*(_common.ptr(t) for t in data_ptrs), *sizes, vec,
                      _common.stream_of(dev))
    _common.raise_on_error(_NAME, code)
    _common.count_launch(_NAME, form)
    return dx_src, dx_dst, dw[0], dw[1]
