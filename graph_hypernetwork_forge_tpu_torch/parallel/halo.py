"""Boundary-minimised halo exchange for node-partitioned message passing.

The port of ``graph_hypernetwork_forge_tpu/parallel/halo.py``.
``parallel/node_partition.py`` gathers the whole h every layer, O(N·d)
bytes per rank however few rows cross the partition. Here a host-side
:class:`HaloPlan` lists, for every (owner → consumer) pair of ranks, the
rows the consumer's edges read from the owner's range, and the exchange
moves only those, in one ``all_to_all`` (:func:`halo_message_passing`).
:func:`locality_relabel` renumbers the nodes by community so that range
partitioning keeps neighbourhoods on one rank.

``halo_width`` B is the largest boundary over all pairs, so one hot pair
pads every pair's block; :class:`ScheduledHaloPlan` instead packs the pairs
into ``ppermute`` rounds, each padded only to its own width
(:func:`scheduled_halo_message_passing`). The volume helpers report the
padded wire volume and the true one.

Rows are copied verbatim and each dst's in-edges all live on its owner, so
the mean (count clamp, averaged W_self, isolated nodes exactly zero) is
the single-process one per node. The plans are numpy, built on the host,
and equal the JAX package's array for array.

While spans record (``utils/profiling.py``), each exchange adds the rows of
the halo buffer this rank receives, padding included, to the ``halo_rows``
counter; its collectives count their calls and bytes themselves
(``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    _edge_contributions_dense,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    all_to_all,
    axis_index,
    copy,
    local_block,
    ppermute,
)
from graph_hypernetwork_forge_tpu_torch.parallel.node_partition import (
    partition_edges_by_dst,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import check_precision
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count, enabled
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-precomputed exchange plan for one graph and mesh size.

    The edge arrays are shard-major over ``num_shards``, as
    :func:`partition_edges_by_dst` lays them out. ``src_halo`` indexes each
    consumer's ``[local rows (npp) ++ halo buffer (k·B)]`` matrix: a local
    source maps to ``src - j·npp``; a source owned by rank ``i`` at send
    slot ``b`` maps to ``npp + i·B + b``.
    """

    src_halo: np.ndarray    # [k * cap] int32, remapped per-consumer indices
    src_global: np.ndarray  # [k * cap] global src ids, same layout
    dst: np.ndarray         # [k * cap] global dst ids
    rel_ids: np.ndarray     # [k * cap]
    edge_mask: np.ndarray   # [k * cap]
    send_idx: np.ndarray    # [k, k, B] owner-local rows rank i sends to j
    nodes_per_shard: int
    halo_width: int         # B (padded max boundary rows per pair)
    num_shards: int
    # True unique boundary rows per (owner i, consumer j); the wire moves
    # the padded B for every pair.
    pair_widths: np.ndarray = None  # [k, k] int64

    @property
    def edge_arrays(self) -> Tuple[np.ndarray, ...]:
        return self.src_halo, self.dst, self.rel_ids, self.edge_mask


def _pair_rows(src_p, mask_p, npp: int, k: int):
    """The sorted unique owner-local rows consumer ``j`` reads from owner
    ``i``, for every pair ``i != j``, and their counts ``[k, k]``."""
    cap = src_p.shape[0] // k
    needed = {}
    pair_widths = np.zeros((k, k), dtype=np.int64)
    for j in range(k):
        sl = slice(j * cap, (j + 1) * cap)
        s = np.asarray(src_p[sl], dtype=np.int64)
        real = np.asarray(mask_p[sl]) > 0
        owner = np.minimum(s // npp, k - 1)
        for i in range(k):
            if i == j:
                continue
            rows = np.unique(s[real & (owner == i)]) - i * npp
            needed[(i, j)] = rows.astype(np.int64)
            pair_widths[i, j] = rows.size
    return needed, pair_widths


def _remap_sources(src_p, mask_p, npp: int, k: int, needed, offset) -> np.ndarray:
    """``src_halo``: each edge's row in its consumer's ``[local ++ halo]``
    buffer; ``offset(i, j)`` is where pair ``(i, j)``'s block starts in the
    halo, or ``None`` for a pair that ships nothing."""
    cap = src_p.shape[0] // k
    src_halo = np.zeros(k * cap, dtype=np.int32)
    for j in range(k):
        sl = slice(j * cap, (j + 1) * cap)
        s = np.asarray(src_p[sl], dtype=np.int64)
        real = np.asarray(mask_p[sl]) > 0
        owner = np.minimum(s // npp, k - 1)
        out = np.zeros(cap, dtype=np.int32)
        local = real & (owner == j)
        out[local] = (s[local] - j * npp).astype(np.int32)
        for i in range(k):
            base = None if i == j else offset(i, j)
            if base is None:
                continue
            sel = real & (owner == i)
            pos = np.searchsorted(needed[(i, j)], s[sel] - i * npp)
            out[sel] = (npp + base + pos).astype(np.int32)
        src_halo[sl] = out
    return src_halo


def build_halo_plan(
    src: np.ndarray,
    dst: np.ndarray,
    rel_ids: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    num_shards: int,
) -> HaloPlan:
    """Partition edges by dst owner and enumerate boundary rows per pair."""
    k = num_shards
    src_p, dst_p, rel_p, mask_p, npp = partition_edges_by_dst(
        src, dst, rel_ids, edge_mask, num_nodes, k
    )
    needed, pair_widths = _pair_rows(src_p, mask_p, npp, k)
    b = round_up_to_multiple(max(int(pair_widths.max(initial=0)), 1), 8)
    send_idx = np.zeros((k, k, b), dtype=np.int32)
    for (i, j), rows in needed.items():
        send_idx[i, j, : rows.size] = rows
    return HaloPlan(
        src_halo=_remap_sources(src_p, mask_p, npp, k, needed, lambda i, j: i * b),
        src_global=src_p,
        dst=dst_p,
        rel_ids=rel_p,
        edge_mask=mask_p,
        send_idx=send_idx,
        nodes_per_shard=npp,
        halo_width=b,
        num_shards=k,
        pair_widths=pair_widths,
    )


def halo_bytes_per_device(plan: HaloPlan, d: int, itemsize: int = 4) -> int:
    """Bytes each rank sends per exchange, without its own block: the
    padded wire volume (:func:`halo_padding_factor` says how much of it is
    padding)."""
    return (plan.num_shards - 1) * plan.halo_width * d * itemsize


def halo_true_bytes_per_device(plan: HaloPlan, d: int, itemsize: int = 4) -> float:
    """Mean unpadded bytes per rank per exchange (unique boundary rows)."""
    return float(plan.pair_widths.sum()) / plan.num_shards * d * itemsize


def halo_padding_factor(plan: HaloPlan) -> float:
    """Padded / true wire volume (1.0 = no padding)."""
    true = float(plan.pair_widths.sum())
    padded = float(plan.num_shards * (plan.num_shards - 1) * plan.halo_width)
    return padded / max(true, 1.0)


def allgather_bytes_per_device(plan: HaloPlan, d: int, itemsize: int = 4) -> int:
    """Bytes each rank sends for the v1 gather of the whole h."""
    return (plan.num_shards - 1) * plan.nodes_per_shard * d * itemsize


def _owner_computes(mesh, axis, full, src_l, dst_l, rel_l, mask_l, w_msg, w_self,
                    bias, npp):
    """The epilogue every exchange shares: contributions from the compact
    ``[npp + halo]`` buffer, aggregated over this rank's node range."""
    w_msg, w_self, bias = (copy(t, mesh, axis) for t in (w_msg, w_self, bias))
    dst_local = dst_l - axis_index(mesh, axis) * npp
    msg, self_c = _edge_contributions_dense(
        full, src_l, dst_local, rel_l, w_msg, w_self, bias
    )
    return two_stream_tail(msg, self_c, dst_local, npp, edge_mask=mask_l)


def halo_message_passing(
    mesh: DeviceMesh,
    h: torch.Tensor,
    plan_arrays: Sequence[torch.Tensor],
    send_idx: torch.Tensor,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    nodes_per_shard: int,
    halo_width: int,
    *,
    axis: str = "edge",
    precision="highest",
) -> torch.Tensor:
    """Owner-computes message passing with an ``all_to_all`` boundary
    exchange.

    ``h`` is this rank's ``[nodes_per_shard, d]`` rows; ``plan_arrays``
    this rank's block of ``plan.edge_arrays`` and ``send_idx`` its
    ``[1, k, B]`` block of ``plan.send_idx`` (:func:`~graph_hypernetwork_
    forge_tpu_torch.parallel.collectives.local_block`); the banks and the
    bias are whole. Returns this rank's ``[nodes_per_shard, d_out]`` rows.
    """
    check_precision(precision)
    src_l, dst_l, rel_l, mask_l = plan_arrays
    k, d = send_idx.shape[1], h.shape[1]
    # Row j of the send buffer holds the rows rank j reads from this range;
    # after the exchange, block i holds what this rank reads from rank i.
    send_buf = h[send_idx[0].reshape(-1).long()].reshape(k, halo_width, d)
    halo = all_to_all(send_buf, mesh, axis).reshape(k * halo_width, d)
    count("halo_rows", k * halo_width)
    return _owner_computes(mesh, axis, torch.cat([h, halo]), src_l, dst_l, rel_l,
                           mask_l, w_msg, w_self, bias, nodes_per_shard)


def locality_relabel(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    iters: int = 10,
) -> np.ndarray:
    """Community-aware relabeling so range partitioning cuts few edges.

    Mode-based label propagation (each node adopts the most frequent label
    among its neighbours; ties go to the smaller label), then nodes ordered
    by ``(label, old id)``. Returns ``perm`` with ``perm[old_id] = new_id``;
    apply as ``src' = perm[src]; dst' = perm[dst]; feats' =
    feats[argsort(perm)]``.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    labels = np.arange(num_nodes, dtype=np.int64)

    for _ in range(max(iters, 0)):
        el = labels[v]
        # Mode of the neighbour labels per node: sort (node, label) pairs,
        # count runs, keep each node's longest run (smallest label on ties).
        order = np.lexsort((el, u))
        uu, ll = u[order], el[order]
        new_run = np.r_[True, (uu[1:] != uu[:-1]) | (ll[1:] != ll[:-1])]
        run_u = uu[new_run]
        run_l = ll[new_run]
        counts = np.diff(np.r_[np.flatnonzero(new_run), uu.size])
        pick = np.lexsort((run_l, -counts, run_u))
        first = np.r_[True, run_u[pick][1:] != run_u[pick][:-1]]
        winners = pick[first]
        new_labels = labels.copy()
        new_labels[run_u[winners]] = run_l[winners]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels

    order = np.lexsort((np.arange(num_nodes), labels))
    perm = np.empty(num_nodes, dtype=np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


# ---------------------------------------------------------------------------
# Scheduled ppermute rounds with per-round padding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduledHaloPlan:
    """Exchange plan as a schedule of ``ppermute`` rounds.

    The k·(k-1) pairs are packed first-fit-decreasing into rounds: each
    round is a matching (every rank sends to at most one peer and receives
    from at most one), a pair joins a round only if the round's width is
    within ``slack`` times its own, and pairs with nothing to send never
    ship. Only the listed pairs move, so wire padding is bounded by
    ``slack``, and the plan holds O(Σ B_ij) rows instead of the
    ``[k, k, B]`` cube.

    ``src_halo`` indexes each consumer's ``[local (npp) ++ halo (Σ B_r)]``
    buffer: a source owned by rank i and read by j sits in the block of the
    round that carries (i, j), at ``npp + round_offset + pos``. A round a
    consumer receives nothing in leaves zero rows it never reads.
    """

    src_halo: np.ndarray            # [k * cap] remapped per-consumer indices
    src_global: np.ndarray          # [k * cap]
    dst: np.ndarray                 # [k * cap]
    rel_ids: np.ndarray             # [k * cap]
    edge_mask: np.ndarray           # [k * cap]
    round_perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # pairs per round
    send_tables: Tuple[np.ndarray, ...]  # per round: [k, B_r] owner rows
    round_widths: Tuple[int, ...]   # (B_1, ..., B_R)
    nodes_per_shard: int
    num_shards: int
    pair_widths: np.ndarray = None  # [k, k] true unique boundary rows

    @property
    def edge_arrays(self) -> Tuple[np.ndarray, ...]:
        return self.src_halo, self.dst, self.rel_ids, self.edge_mask

    @property
    def halo_rows(self) -> int:
        return int(sum(self.round_widths))

    @property
    def num_rounds(self) -> int:
        return len(self.round_widths)


def _schedule_rounds(pair_widths: np.ndarray, slack: float = 2.0):
    """First-fit-decreasing matching schedule: rounds ``(pairs, width)``,
    ``pairs`` a matching and ``width`` its largest boundary rounded up to a
    multiple of 8. Pairs go in order of width, largest first, so a pair only
    joins a round at most ``slack`` times its width; ties are broken by
    (owner, consumer)."""
    k = pair_widths.shape[0]
    pairs = sorted(
        ((int(pair_widths[i, j]), i, j)
         for i in range(k) for j in range(k)
         if i != j and pair_widths[i, j] > 0),
        key=lambda t: (-t[0], t[1], t[2]),
    )
    rounds = []  # [senders, receivers, pairs, width]
    for w, i, j in pairs:
        for r in rounds:
            if i not in r[0] and j not in r[1] and r[3] <= slack * w:
                r[0].add(i)
                r[1].add(j)
                r[2].append((i, j))
                break
        else:
            rounds.append([{i}, {j}, [(i, j)], round_up_to_multiple(max(w, 1), 8)])
    return [(tuple(r[2]), int(r[3])) for r in rounds]


def build_scheduled_halo_plan(
    src: np.ndarray,
    dst: np.ndarray,
    rel_ids: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    slack: float = 2.0,
) -> ScheduledHaloPlan:
    """Partition by dst owner, enumerate the per-pair boundaries (as
    :func:`build_halo_plan`), and pack the pairs into ``ppermute`` rounds."""
    k = num_shards
    src_p, dst_p, rel_p, mask_p, npp = partition_edges_by_dst(
        src, dst, rel_ids, edge_mask, num_nodes, k
    )
    needed, pair_widths = _pair_rows(src_p, mask_p, npp, k)
    schedule = _schedule_rounds(pair_widths, slack=slack)
    round_widths = [w for _, w in schedule]
    offsets = np.concatenate([[0], np.cumsum(round_widths)]).astype(np.int64)

    send_tables = []
    pair_round = {}
    for ri, (prs, w) in enumerate(schedule):
        tbl = np.zeros((k, w), dtype=np.int32)
        for (i, j) in prs:
            rows = needed[(i, j)]
            tbl[i, : rows.size] = rows
            pair_round[(i, j)] = ri
        send_tables.append(tbl)

    def offset(i, j):
        return offsets[pair_round[(i, j)]] if (i, j) in pair_round else None

    return ScheduledHaloPlan(
        src_halo=_remap_sources(src_p, mask_p, npp, k, needed, offset),
        src_global=src_p,
        dst=dst_p,
        rel_ids=rel_p,
        edge_mask=mask_p,
        round_perms=tuple(prs for prs, _ in schedule),
        send_tables=tuple(send_tables),
        round_widths=tuple(round_widths),
        nodes_per_shard=npp,
        num_shards=k,
        pair_widths=pair_widths,
    )


def scheduled_halo_exchange(
    mesh: DeviceMesh,
    h_local: torch.Tensor,
    send_tables_l: Sequence[torch.Tensor],
    round_perms,
    axis: str = "edge",
) -> torch.Tensor:
    """The ``ppermute`` schedule, one exchange a round.

    ``send_tables_l`` are this rank's ``[1, B_r]`` rows of the plan's send
    tables, ``round_perms`` the pairs of each round. Returns the consumer's
    ``[Σ B_r, d]`` halo buffer (round-major blocks matching
    ``ScheduledHaloPlan.src_halo``; a round this rank receives nothing in
    is zeros), or an empty ``[0, d]`` one when there are no rounds.
    """
    blocks = [
        ppermute(h_local[tbl[0].long()], mesh, axis, perm)
        for tbl, perm in zip(send_tables_l, round_perms)
    ]
    if enabled():
        count("halo_rows", sum(b.shape[0] for b in blocks))
    if not blocks:
        return h_local.new_zeros((0, h_local.shape[1]))
    return torch.cat(blocks)


def scheduled_halo_message_passing(
    mesh: DeviceMesh,
    h: torch.Tensor,
    plan: ScheduledHaloPlan,
    w_msg: torch.Tensor,
    w_self: torch.Tensor,
    bias: torch.Tensor,
    *,
    axis: str = "edge",
    precision="highest",
) -> torch.Tensor:
    """Owner-computes message passing over the scheduled ``ppermute``
    rounds: :func:`halo_message_passing`'s semantics, another exchange.

    ``h`` is this rank's ``[nodes_per_shard, d]`` rows and ``plan`` the
    whole host plan, whose rows for this rank the function picks. Returns
    this rank's ``[nodes_per_shard, d_out]`` rows.
    """
    check_precision(precision)
    src_l, dst_l, rel_l, mask_l = (
        local_block(torch.as_tensor(a, device=h.device), mesh, axis)
        for a in plan.edge_arrays
    )
    me = axis_index(mesh, axis)
    tables = [torch.as_tensor(t[me:me + 1], device=h.device) for t in plan.send_tables]
    halo = scheduled_halo_exchange(mesh, h, tables, plan.round_perms, axis)
    return _owner_computes(mesh, axis, torch.cat([h, halo]), src_l, dst_l, rel_l,
                           mask_l, w_msg, w_self, bias, plan.nodes_per_shard)


def scheduled_halo_wire_rows(plan: ScheduledHaloPlan) -> int:
    """Rows sent per exchange over all ranks (only listed pairs ship;
    padding counts only within a shipped block)."""
    return int(
        sum(len(prs) * w for prs, w in zip(plan.round_perms, plan.round_widths))
    )


def scheduled_halo_bytes_per_device(plan: ScheduledHaloPlan, d: int,
                                    itemsize: int = 4) -> float:
    """Mean bytes each rank sends per exchange."""
    return scheduled_halo_wire_rows(plan) / plan.num_shards * d * itemsize


def scheduled_halo_padding_factor(plan: ScheduledHaloPlan) -> float:
    """Sent / true unique boundary rows (1.0 = tight)."""
    true = float(plan.pair_widths.sum())
    return scheduled_halo_wire_rows(plan) / max(true, 1.0)
