"""Edge-partitioned message passing: local partial sums, one ``psum``.

The port of ``graph_hypernetwork_forge_tpu/parallel/edge_partition.py``.
The edge list is sharded over the ``"edge"`` axis; each rank computes its
edges' contributions and *partial* segment sums over the full node range,
then one reduction over the axis completes the two-phase mean::

    phase 1 (local):   partial_sum_v = Σ_{local e→v} msg_e ,  partial_cnt_v
    phase 2 (psum):    sum_v = psum(partial_sum_v), cnt_v = psum(partial_cnt_v)
    divide:            agg_v = sum_v / max(cnt_v, 1)

The divide comes after the reduction, so the result is the single-process
mean up to the order of the f32 sums. The message sums, the self sums and
the counts travel in one ``[N, 2·d_out + 1]`` reduction. The local compute
is the ``dense`` backend's, as in JAX.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    _edge_contributions_dense,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import segment_sum
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import copy, psum
from graph_hypernetwork_forge_tpu_torch.utils.initializers import check_precision


def edge_partitioned_message_passing(
    mesh: DeviceMesh,
    h: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    *,
    edge_mask: torch.Tensor | None = None,
    axis: str = "edge",
    precision="highest",
) -> torch.Tensor:
    """Relation-conditioned message passing with edges sharded over ``axis``.

    ``h`` ``[N, d]``, the banks and the bias are whole (replicated);
    ``src``, ``dst``, ``rel_ids`` and ``edge_mask`` are this rank's block of
    the edge list. Returns the whole ``[N, d_out]``, replicated.
    """
    check_precision(precision)
    n = h.shape[0]
    if edge_mask is None:
        edge_mask = torch.ones(src.shape, dtype=h.dtype, device=h.device)
    h, w_msg, w_self, bias = (copy(t, mesh, axis) for t in (h, w_msg, w_self, bias))
    msg, self_c = _edge_contributions_dense(h, src, dst, rel_ids, w_msg, w_self, bias)
    m = edge_mask.to(msg.dtype)[:, None]
    total = psum(segment_sum(torch.cat([msg * m, self_c * m, m], 1), dst, n), mesh, axis)
    d = msg.shape[1]
    cnt = total[:, 2 * d:].clamp(min=1.0)
    return total[:, :d] / cnt + total[:, d:2 * d] / cnt
