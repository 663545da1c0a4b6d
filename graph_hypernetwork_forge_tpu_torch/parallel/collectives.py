"""Collectives over one axis of a mesh, differentiated as JAX differentiates
``shard_map``.

A port function of ``parallel/`` is the body of the JAX package's
``shard_map``, run on every rank of the mesh's axis. **Convention:** it
takes the rank's local block wherever JAX's ``in_specs`` says ``P(axis)``,
and the whole array where it says ``P()``, exactly what the ``shard_map``
body sees; it returns the local block for a ``P(axis)`` output and the
whole array for a ``P()`` one. :func:`local_block` cuts a rank's rows of a
shard-major array. Host plans (``HaloPlan``, ``ScheduledHaloPlan``) are
whole on every rank, and the function picks its own rows.

**Gradients.** A value is either *replicated* (the same on every rank of
the axis: a ``P()`` input or output) or *per-rank*. The functions here
move between the two with JAX's transpose rules, so a backward through a
port function gives every rank the gradient of the single-process run:

- :func:`copy`: replicated → per-rank. Identity forward; backward the sum
  of the ranks' cotangents (JAX's ``pvary``, Megatron's ``f``). Every
  replicated operand goes through it before per-rank work uses it.
- :func:`psum`: per-rank → replicated. The sum forward; backward the
  identity (JAX's ``psum``, Megatron's ``g``). With :func:`copy` it is the
  copy/reduce pair.
- :func:`all_gather`: per-rank blocks → the replicated whole, tiled on
  axis 0; backward the rank's own block of the cotangent (JAX's
  ``all_gather_invariant``).
- :func:`all_to_all`: chunk ``j`` of axis 0 to rank ``j``; backward the
  same exchange of the cotangent.
- :func:`ppermute`: ``(source, destination)`` pairs of axis indices;
  backward the inverse permutation. A rank that receives nothing gets
  zeros.

A loss on a replicated value is computed on every rank and backpropagated
on every rank; a loss on per-rank blocks is each rank's part of the whole
(their sum is the loss; :func:`psum` it to read it). Either way each
rank's gradients are the single-process ones. ``torch.distributed.nn``'s
collectives are not used: their ``all_gather`` sums every rank's cotangent
in the backward, which gives a replicated loss k times the gradient.

**Tracing.** While spans record (``utils/profiling.py``), every collective
this module issues, forward or backward, is a span ``collective.<op>``
(``all_reduce``, ``all_gather``, ``all_to_all``, ``ppermute``) and adds 1
to ``collective_calls`` and its payload to ``collective_bytes``: the bytes
of the tensor this rank hands to the collective (its block for a gather,
what it sends for a ``ppermute``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count, span


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def local_block(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of the rows of a shard-major array: the block the
    ``shard_map`` body sees for ``P(axis)``."""
    k = mesh_axis_size(mesh, axis)
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split over {k} ranks of {axis!r}")
    rows = x.shape[0] // k
    return x[axis_index(mesh, axis) * rows:][:rows]


def _counted(name: str, nbytes: int):
    """The span ``name`` of one collective, counted with its payload."""
    count("collective_calls", 1)
    count("collective_bytes", nbytes)
    return span(name)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    with _counted("collective.all_reduce", out.nbytes):
        dist.all_reduce(out, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.rows = index, x.shape[0]
        k = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
        with _counted("collective.all_gather", x.nbytes):
            getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows:][:ctx.rows], None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    with _counted("collective.all_to_all", x.nbytes):
        dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _permute(x: torch.Tensor, group, index: int, perm) -> torch.Tensor:
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops, sends = [], 0
    for src, dst in perm:
        if src == index and dst == index:
            out.copy_(x)
        elif src == index:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
            sends += 1
        elif dst == index:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    with _counted("collective.ppermute", sends * x.nbytes):
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, perm):
        ctx.group, ctx.index, ctx.perm = group, index, perm
        return _permute(x, group, index, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _permute(g, ctx.group, ctx.index, inverse), None, None, None


def copy(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """A replicated operand on its way into per-rank work: the identity,
    whose backward sums the cotangent over ``axis``."""
    return _Copy.apply(x, mesh.get_group(axis))


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, replicated; backward the identity."""
    return _Psum.apply(x, mesh.get_group(axis))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' blocks concatenated on axis 0 in rank order (``tiled``),
    replicated; backward this rank's block of the cotangent."""
    return _AllGather.apply(x, mesh.get_group(axis), axis_index(mesh, axis))


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: chunk ``j``
    of axis 0 goes to rank ``j``, and chunk ``i`` of the result came from
    rank ``i``."""
    return _AllToAll.apply(x, mesh.get_group(axis))


def ppermute(
    x: torch.Tensor, mesh: DeviceMesh, axis: str,
    perm: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """``lax.ppermute``: each ``(i, j)`` of ``perm`` sends rank ``i``'s ``x``
    to rank ``j`` (axis indices); a rank no pair sends to gets zeros."""
    perm = tuple((int(i), int(j)) for i, j in perm)
    return _Ppermute.apply(x, mesh.get_group(axis), axis_index(mesh, axis), perm)
