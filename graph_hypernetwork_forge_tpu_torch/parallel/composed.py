"""Composed multi-device training: relation sharding, node-partitioned
message passing and the gradient reduction in one step.

The port of ``graph_hypernetwork_forge_tpu/parallel/composed.py``. Over one
mesh axis:

- **nodes** are range-sharded: each rank owns the aggregation and the
  residual/ReLU/LayerNorm epilogue of its node rows;
- **edges** are partitioned by dst owner (``partition_edges_by_dst``), so
  no segment sum crosses ranks;
- **relations** are sharded: each rank encodes U/k texts and generates its
  rows of every layer's banks, which one ``all_gather`` per layer assembles;
- the **halo** exchange (``parallel/halo.py``) moves only boundary rows, one
  ``all_to_all`` (or scheduled ``ppermute`` rounds) a layer, and a rank's
  work runs over its ``npp + k·B`` local and halo rows; ``halo=False`` is
  the dense v1, one ``all_gather`` of the whole h a layer;
- the **loss** is the margin-ranking objective over the rank's edges,
  reduced with ``psum``; ``neg_mode="local_roll"`` scores locally (one more
  boundary exchange for the heads, each shard's tails rotated as
  negatives), ``"uniform_global"`` gathers the embeddings once.

The contribution backends ``pallas`` / ``pallas_packed`` (or ``cuda``)
rebuild a SortPlan per shard from the host plan of
:func:`prepare_composed_inputs` and run the single-card ``cuda`` backend
over it (kernels 2 and 3, kernel 1 for every reduction), the run table of
kernel 3 included, so no backward builds one.

Functions follow ``collectives.py``'s convention: the step takes this
rank's blocks of the shard-major arrays and the whole replicated
parameters, which enter the per-rank work through ``copy``; the Adam update
runs replicated and identically on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.data.encoding import (
    EncodedGraph,
    SortPlan,
    build_sort_plan,
)
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import apply_text_encoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    apply_weight_generator,
    draw_dropout_masks,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    _edge_contributions_dense,
    _RaggedTransform,
    relational_message_passing,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import sorted_segment_sum_by_plan
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    axis_index,
    copy,
    local_block,
    psum,
)
from graph_hypernetwork_forge_tpu_torch.parallel.halo import (
    build_halo_plan,
    build_scheduled_halo_plan,
    scheduled_halo_exchange,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.parallel.node_partition import (
    partition_edges_by_dst,
)
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    layer_norm_apply,
    linear_apply,
    tree_map,
)
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple

KERNEL_CONTRIBS = ("pallas", "pallas_packed", "cuda")


@dataclasses.dataclass(frozen=True)
class ComposedInputs:
    """Host arrays for the composed step, shard-major over ``num_shards``."""

    feats: np.ndarray       # [N_pad, F] node-range shardable
    src: np.ndarray         # [k * cap] shard-major edges (dst-owned), global ids
    dst: np.ndarray
    rel_ids: np.ndarray
    edge_mask: np.ndarray
    char_ids: np.ndarray    # [U_pad, L], U_pad divisible by k
    lengths: np.ndarray
    nodes_per_shard: int
    num_nodes: int          # true N (un-padded)
    # Boundary-minimised halo exchange (parallel/halo.py); None: the dense
    # v1 all_gather of the whole h a layer.
    src_halo: Optional[np.ndarray] = None   # [k * cap] local ++ halo indices
    send_idx: Optional[np.ndarray] = None   # [k, k, B]
    halo_width: int = 0
    # Scheduled ppermute rounds (ScheduledHaloPlan): per-round [k, B_r]
    # send tables and the rounds' pairs; src_halo then indexes
    # [local ++ Σ B_r round blocks].
    sched_send_tables: Optional[Tuple[np.ndarray, ...]] = None
    sched_round_perms: Optional[Tuple[Tuple[Tuple[int, int], ...], ...]] = None
    # Per-shard group sizes [k, U_pad] of a relation-sorted shard slice
    # (rel_sort_local=True): the grouped contribution backend's.
    rel_group_sizes: Optional[np.ndarray] = None
    # Per-shard sort-free aggregation plan: a permutation to dst order, its
    # inverse, the sorted local dst, CSR bounds and masked degrees.
    agg_dst_perm: Optional[np.ndarray] = None    # [k*cap] local row perm
    agg_inv_perm: Optional[np.ndarray] = None    # [k*cap]
    agg_dst_sorted: Optional[np.ndarray] = None  # [k*cap] local dst, sorted
    agg_dst_splits: Optional[np.ndarray] = None  # [k, npp+1] CSR bounds
    agg_in_degree: Optional[np.ndarray] = None   # [k, npp] masked degrees
    # Per-shard whole SortPlan (group_pad > 0): with the agg plan, the
    # single-card plan of each shard, its src over the shard's [local ++
    # halo] rows. The last two are the port's run table of kernel 3
    # (SortPlan.tile_splits / run_splits), built here per shard.
    kernel_src_perm: Optional[np.ndarray] = None      # [k*cap]
    kernel_inv_src_perm: Optional[np.ndarray] = None  # [k*cap]
    kernel_src_sorted: Optional[np.ndarray] = None    # [k*cap]
    kernel_src_splits: Optional[np.ndarray] = None    # [k, rows+1]
    kernel_dst_splits: Optional[np.ndarray] = None    # [k, rows+1]
    kernel_rel_splits: Optional[np.ndarray] = None    # [k, U_pad+1]
    kernel_rel_counts: Optional[np.ndarray] = None    # [k, U_pad]
    kernel_tile_splits: Optional[np.ndarray] = None   # [k, U_pad+1]
    kernel_run_splits: Optional[np.ndarray] = None    # [k, U_pad+1]

    @property
    def agg_plan(self):
        """The 5-tuple the step's ``agg_plan=`` expects (or None)."""
        if self.agg_dst_perm is None:
            return None
        return (
            self.agg_dst_perm, self.agg_inv_perm, self.agg_dst_sorted,
            self.agg_dst_splits, self.agg_in_degree,
        )

    @property
    def kernel_plan(self):
        """The tuple the step's ``kernel_plan=`` expects (or None): JAX's
        seven arrays, then the run table's two."""
        if self.kernel_src_perm is None:
            return None
        return (
            self.kernel_src_perm, self.kernel_inv_src_perm,
            self.kernel_src_sorted, self.kernel_src_splits,
            self.kernel_dst_splits, self.kernel_rel_splits,
            self.kernel_rel_counts, self.kernel_tile_splits,
            self.kernel_run_splits,
        )


def _group_pad_layout(src, dst, rel, mask, src_halo, counts, group_pad, npp, k):
    """Each shard's relation groups padded to ``group_pad`` rows, the shards
    to one common length: the single-card kernels' layout, per shard. Pad
    rows carry the group's relation, the shard's first node and mask 0; the
    rows after the last group extend it."""
    cap = src.shape[0] // k
    padded_counts = -(-counts // group_pad) * group_pad * (counts > 0)
    cap2 = int(-(-padded_counts.sum(axis=1).max() // group_pad) * group_pad)
    out = [np.zeros(k * cap2, dtype=np.asarray(a).dtype) for a in (src, dst, rel, mask)]
    src2, dst2, rel2, mask2 = out
    srch2 = None if src_halo is None else np.zeros(k * cap2, dtype=src_halo.dtype)
    u_pad = counts.shape[1]
    for j in range(k):
        base_in, base_out = j * cap, j * cap2
        in_off = np.zeros(u_pad + 1, dtype=np.int64)
        np.cumsum(counts[j], out=in_off[1:])
        pos = last_rel = 0
        for r in range(u_pad):
            c = int(counts[j, r])
            if c == 0:
                continue
            s_in, s_out = base_in + in_off[r], base_out + pos
            for a, b in zip((src, dst, rel, mask), out):
                b[s_out:s_out + c] = a[s_in:s_in + c]
            if srch2 is not None:
                srch2[s_out:s_out + c] = src_halo[s_in:s_in + c]
            pad = int(padded_counts[j, r]) - c
            if pad:
                pe = s_out + c
                rel2[pe:pe + pad] = r
                src2[pe:pe + pad] = j * npp
                dst2[pe:pe + pad] = j * npp
            pos += int(padded_counts[j, r])
            last_rel = r
        if pos < cap2:
            tail = slice(base_out + pos, base_out + cap2)
            rel2[tail] = last_rel
            src2[tail] = j * npp
            dst2[tail] = j * npp
    return src2, dst2, rel2, mask2, srch2, cap2


def prepare_composed_inputs(
    graph: EncodedGraph, node_features, num_shards: int, *, halo: bool = True,
    rel_sort_local: bool = False, scheduled: bool = False, group_pad: int = 0,
) -> ComposedInputs:
    """Partition a graph and its features for :func:`make_composed_train_step`
    on the host, array for array as the JAX package does.

    ``halo=True`` (the default) builds a ``HaloPlan`` (``scheduled=True``: a
    ``ScheduledHaloPlan``), so the per-layer exchange moves boundary rows
    only and a rank's products run over its ``npp + k·B`` rows;
    ``halo=False`` keeps the dense v1. ``rel_sort_local=True`` stable-sorts
    each shard's edges by relation and records its group sizes (the
    ``grouped`` backend's layout); ``group_pad`` (which needs it) pads each
    shard's groups to that many rows and builds each shard's whole
    SortPlan, run table included (the kernel backends' layout).
    """
    feats = np.asarray(node_features, dtype=np.float32)
    if scheduled and not halo:
        raise ValueError(
            "scheduled=True requires halo=True: the scheduled ppermute "
            "rounds are a halo-exchange layout, not a standalone mode"
        )
    if group_pad and not rel_sort_local:
        raise ValueError("group_pad requires rel_sort_local=True")
    n, k = graph.num_nodes, num_shards
    src_halo = send_idx = sched_tables = sched_perms = None
    halo_width = 0
    edges = (graph.src, graph.dst, graph.rel_ids, graph.edge_mask, n, k)
    if halo and scheduled:
        plan = build_scheduled_halo_plan(*edges)
        _, dst, rel, mask = plan.edge_arrays
        src, npp, src_halo = plan.src_global, plan.nodes_per_shard, plan.src_halo
        sched_tables, sched_perms = plan.send_tables, plan.round_perms
        halo_width = plan.halo_rows  # the whole halo a consumer receives
    elif halo:
        plan = build_halo_plan(*edges)
        _, dst, rel, mask = plan.edge_arrays
        src, npp, src_halo = plan.src_global, plan.nodes_per_shard, plan.src_halo
        send_idx, halo_width = plan.send_idx, plan.halo_width
    else:
        src, dst, rel, mask, npp = partition_edges_by_dst(*edges)
    n_pad = npp * k
    if n_pad > feats.shape[0]:
        feats = np.pad(feats, ((0, n_pad - feats.shape[0]), (0, 0)))

    u_pad = round_up_to_multiple(graph.char_ids.shape[0], k)
    char_ids = np.zeros((u_pad, graph.char_ids.shape[1]), dtype=np.int32)
    lengths = np.ones(u_pad, dtype=np.int32)
    char_ids[: graph.char_ids.shape[0]] = graph.char_ids
    lengths[: graph.text_lengths.shape[0]] = graph.text_lengths

    cap = src.shape[0] // k
    rel_group_sizes = None
    if rel_sort_local:
        # Pad rows carry rel 0 and mask 0: they sort into group 0 and add 0.
        src, dst, rel, mask = (np.array(a) for a in (src, dst, rel, mask))
        src_halo = None if src_halo is None else np.array(src_halo)
        rel_group_sizes = np.zeros((k, u_pad), dtype=np.int32)
        for j in range(k):
            sl = slice(j * cap, (j + 1) * cap)
            order = np.argsort(rel[sl], kind="stable")
            for arr in (src, dst, rel, mask) + (() if src_halo is None else (src_halo,)):
                arr[sl] = arr[sl][order]
            rel_group_sizes[j] = np.bincount(rel[sl], minlength=u_pad)

    kernel = {}
    if group_pad:
        src, dst, rel, mask, src_halo, cap = _group_pad_layout(
            src, dst, rel, mask, src_halo, rel_group_sizes.astype(np.int64),
            group_pad, npp, k)
    # The per-shard sort-free aggregation plan over the final layout.
    agg = dict(perm=np.empty(k * cap, np.int32), inv=np.empty(k * cap, np.int32),
               sorted=np.empty(k * cap, np.int32), splits=np.empty((k, npp + 1), np.int32),
               indeg=np.empty((k, npp), np.float32))
    if group_pad:
        # The rows each shard's gathers index: [local ++ halo], or the whole
        # gathered table in the dense v1.
        if halo and scheduled:
            table_rows = npp + halo_width
        elif halo:
            table_rows = npp + k * halo_width
        else:
            table_rows = n_pad
        src_dom = src_halo if halo else src
        fields = dict(src_perm=k * cap, inv_src_perm=k * cap, src_sorted=k * cap,
                      src_splits=(k, table_rows + 1), dst_splits=(k, table_rows + 1),
                      rel_splits=(k, u_pad + 1), rel_counts=(k, u_pad),
                      tile_splits=(k, u_pad + 1), run_splits=(k, u_pad + 1))
        kernel = {f"kernel_{f}": np.empty(shape, np.int32) for f, shape in fields.items()}
        for j in range(k):
            sl = slice(j * cap, (j + 1) * cap)
            ldst = (np.asarray(dst[sl]) - j * npp).astype(np.int32)
            pj = build_sort_plan(np.asarray(src_dom[sl]).astype(np.int32), ldst,
                                 np.asarray(rel[sl]).astype(np.int32),
                                 np.asarray(mask[sl]), table_rows, u_pad)
            agg["perm"][sl], agg["inv"][sl] = pj.dst_perm, pj.inv_dst_perm
            agg["sorted"][sl] = pj.dst_sorted
            agg["splits"][j] = pj.dst_splits[: npp + 1]
            agg["indeg"][j] = pj.in_degree[:npp]
            for f in fields:
                kernel[f"kernel_{f}"][sl if fields[f] == k * cap else j] = getattr(pj, f)
        # The group sizes of the final layout (the trailing pad rows count
        # into each shard's last relation), so grouped runs on it too.
        rel_group_sizes = kernel["kernel_rel_counts"]
    else:
        node_bounds = np.arange(npp + 1, dtype=np.int32)
        for j in range(k):
            sl = slice(j * cap, (j + 1) * cap)
            ldst = (np.asarray(dst[sl]) - j * npp).astype(np.int64)
            order = np.argsort(ldst, kind="stable").astype(np.int32)
            agg["perm"][sl] = order
            inv = np.empty(cap, dtype=np.int32)
            inv[order] = np.arange(cap, dtype=np.int32)
            agg["inv"][sl] = inv
            ds = ldst[order].astype(np.int32)
            agg["sorted"][sl] = ds
            agg["splits"][j] = np.searchsorted(ds, node_bounds, side="left")
            # Pad rows of a shard whose range starts past the last node
            # carry an out-of-range dst with mask 0: clipped for bincount,
            # outside every CSR interval in the sorted sum.
            agg["indeg"][j] = np.bincount(
                np.clip(ldst, 0, npp - 1),
                weights=np.asarray(mask[sl], dtype=np.float64), minlength=npp,
            )[:npp].astype(np.float32)

    return ComposedInputs(
        feats=feats, src=src, dst=dst, rel_ids=rel, edge_mask=mask,
        char_ids=char_ids, lengths=lengths, nodes_per_shard=npp, num_nodes=n,
        src_halo=src_halo, send_idx=send_idx, halo_width=halo_width,
        sched_send_tables=sched_tables, sched_round_perms=sched_perms,
        rel_group_sizes=rel_group_sizes,
        agg_dst_perm=agg["perm"], agg_inv_perm=agg["inv"],
        agg_dst_sorted=agg["sorted"], agg_dst_splits=agg["splits"],
        agg_in_degree=agg["indeg"], **kernel,
    )


def local_inputs(inputs: ComposedInputs, mesh: DeviceMesh, axis: str = "edge",
                 device=None) -> Tuple[tuple, dict]:
    """This rank's blocks of ``inputs`` as tensors on ``device``:
    ``(arrays, kwargs)`` for ``step(params, opt_state, *arrays, gen,
    **kwargs)`` (``feats``, the edge arrays, ``chars``, ``lens``; then
    ``src_halo``, ``send_idx`` (the per-round tables when scheduled),
    ``rel_group_sizes``, ``agg_plan`` and ``kernel_plan`` where present)."""
    def blk(a):
        return local_block(torch.as_tensor(np.asarray(a), device=device), mesh, axis)

    arrays = tuple(blk(a) for a in (inputs.feats, inputs.src, inputs.dst, inputs.rel_ids,
                                    inputs.edge_mask, inputs.char_ids, inputs.lengths))
    kw = {}
    if inputs.src_halo is not None:
        kw["src_halo"] = blk(inputs.src_halo)
        kw["send_idx"] = (tuple(blk(t) for t in inputs.sched_send_tables)
                          if inputs.sched_send_tables is not None else blk(inputs.send_idx))
    if inputs.rel_group_sizes is not None:
        kw["rel_group_sizes"] = blk(inputs.rel_group_sizes)
    for name in ("agg_plan", "kernel_plan"):
        plan = getattr(inputs, name)
        if plan is not None:
            kw[name] = tuple(blk(a) for a in plan)
    return arrays, kw


def _gather_rows(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A local row index as JAX gathers it: negative ids wrap once, and the
    rest clamp into ``[0, size)``. Only pad rows (mask 0) of a shard whose
    node range starts past the last node carry such ids."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _local_plan(agg, kern, npp: int) -> SortPlan:
    """The shard's single-card SortPlan from its blocks of the host plans."""
    perm, inv, dsort, _, indeg = agg
    (sperm, isperm, ssort, ssplits, dsplits, rsplits, rcounts, tsplits,
     runs) = kern
    return SortPlan(
        dst_perm=perm, inv_dst_perm=inv, dst_sorted=dsort.clamp(0, npp - 1),
        src_perm=sperm, inv_src_perm=isperm, src_sorted=ssort,
        in_degree=indeg[0], rel_counts=rcounts[0], dst_splits=dsplits[0],
        src_splits=ssplits[0], rel_splits=rsplits[0], tile_splits=tsplits[0],
        run_splits=runs[0],
    )


def _composed_layers(mesh, config, params, npp, axis, feats_l, src_rows, dst_l, rel_l,
                     mask_l, chars_l, lens_l, exchange, *, halo, contrib="dense",
                     sizes=None, agg=None, plan=None, gen=None):
    """The per-rank forward over the rank's node, edge and relation blocks:
    ``[npp, H]``, the rank's rows of the embeddings. ``params`` have entered
    through ``copy``; ``exchange(h)`` returns the rows ``src_rows`` index
    (``[local ++ halo]``, or the whole gathered h in the dense v1). Dropout
    (``gen`` given, ``config.dropout > 0``) draws per layer the generator's
    masks for the rank's relations, then the rank's row mask."""
    me = axis_index(mesh, axis)
    p = config.dropout
    use_dropout = gen is not None and p > 0.0
    wg_cfg = config.weight_generator
    h = torch.relu(linear_apply(params["input_proj"], feats_l, precision=config.precision))
    text = apply_text_encoder(params["text_encoder"], chars_l, lens_l,
                              precision=config.precision)
    local_dst = _gather_rows(dst_l - me * npp, npp)
    self_rows = local_dst if halo else dst_l
    for layer in range(config.num_layers):
        wg_keep = h_keep = None
        if use_dropout:
            wg_keep = draw_dropout_masks(wg_cfg, text.shape[0], gen)
            h_keep = torch.rand((npp, config.hidden_dim), generator=gen,
                                device=gen.device) < 1.0 - p
        local_w = apply_weight_generator(wg_cfg, params["weight_generators"][layer], text,
                                         train=use_dropout, keep=wg_keep)
        w = {name: copy(all_gather(v, mesh, axis), mesh, axis) for name, v in local_w.items()}
        rows = exchange(h)
        if contrib in KERNEL_CONTRIBS:
            h_new = relational_message_passing(
                rows, src_rows, local_dst, rel_l, w["W_msg"], w["W_self"], w["bias"],
                num_nodes=npp, edge_mask=mask_l, backend=contrib,
                precision=config.precision, rel_sorted=True, group_padded=True,
                sort_plan=plan,
            )
        else:
            if contrib == "grouped":
                msg = (_RaggedTransform.apply(rows.index_select(0, src_rows), w["W_msg"], sizes)
                       + w["bias"].index_select(0, rel_l))
                selfc = _RaggedTransform.apply(rows.index_select(0, self_rows), w["W_self"],
                                               sizes)
            else:
                msg, selfc = _edge_contributions_dense(rows, src_rows, self_rows, rel_l,
                                                       w["W_msg"], w["W_self"], w["bias"])
            if agg is not None:
                # Sort-free tail: one summed reduction in dst order through
                # the shard's plan, static degrees.
                perm, inv, dsort, splits, indeg = agg
                both = (msg + selfc) * mask_l[:, None]
                total = sorted_segment_sum_by_plan(both, perm, inv, dsort.clamp(0, npp - 1),
                                                   npp, splits[0])
                h_new = total / indeg[0].clamp(min=1.0)[:, None]
            else:
                h_new = two_stream_tail(msg, selfc, local_dst, npp, edge_mask=mask_l)
        h_new = torch.relu(h_new + h)
        if h_keep is not None:
            h_new = torch.where(h_keep, h_new / (1.0 - p), 0.0)
        h = layer_norm_apply(params["layer_norms"][layer], h_new)
    return h


def _halo_exchange(mesh, axis, send_l, halo_width, scheduled_rounds) -> Callable:
    """``h → [h ++ halo]`` of the halo plan: one ``all_to_all`` of the
    ``[1, k, B]`` send table, or the scheduled rounds' ``ppermute``s. Each
    exchange adds the halo rows it receives to ``halo_rows`` while spans
    record (``parallel/halo.py``)."""
    if scheduled_rounds is not None:
        return lambda h: torch.cat(
            [h, scheduled_halo_exchange(mesh, h, send_l, scheduled_rounds, axis)])

    def exchange(h):
        k, d = send_l.shape[1], h.shape[1]
        buf = h.index_select(0, send_l[0].reshape(-1)).reshape(k, halo_width, d)
        count("halo_rows", k * halo_width)
        return torch.cat([h, all_to_all(buf, mesh, axis).reshape(k * halo_width, d)])

    return exchange


def _dense_exchange(mesh, axis) -> Callable:
    """The dense v1: the whole h, gathered, entering per-rank work."""
    return lambda h: copy(all_gather(h, mesh, axis), mesh, axis)


def _masked_mean(per_edge, mask_l, mesh, axis) -> torch.Tensor:
    """The mask-weighted mean over every shard's edges: ``psum`` of the
    numerator and of the denominator (the reference's plain mean over the
    real edges, demo.py:96)."""
    num = psum(per_edge.sum(), mesh, axis)
    den = psum(mask_l.sum(), mesh, axis)
    return num / den.clamp(min=1.0)


def _local_roll_loss(mesh, axis, h, rows, srch_l, local_dst, mask_l, shift: int,
                     margin: float) -> torch.Tensor:
    """Local scoring: heads from ``rows`` (the halo exchange of the final
    embeddings), owner-local tails, and the tails rotated by ``shift`` as
    negatives (a permutation of the shard's dst)."""
    head = rows.index_select(0, srch_l)
    tail = h.index_select(0, local_dst)
    neg_tail = torch.roll(tail, -shift, dims=0)
    pos, neg = (head * tail).sum(-1), (head * neg_tail).sum(-1)
    return _masked_mean((margin - pos + neg).clamp(min=0.0) * mask_l, mask_l, mesh, axis)


def make_composed_train_step(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    optimizer: Optimizer,
    nodes_per_shard: int,
    *,
    axis: str = "edge",
    margin: float = 1.0,
    num_nodes: Optional[int] = None,
    halo_width: Optional[int] = None,
    neg_mode: Optional[str] = None,
    contrib: str = "dense",
    agg_sorted: bool = False,
    scheduled_rounds=None,
) -> Callable:
    """The composed training step (forward, backward, Adam) on one axis.

    Returns ``step(params, opt_state, feats, src, dst, rel, mask, chars,
    lens, gen, src_halo=None, send_idx=None, rel_group_sizes=None,
    agg_plan=None, kernel_plan=None, neg=None) → (params, opt_state,
    loss)``: every array this rank's block of the :class:`ComposedInputs`
    arrays (:func:`local_inputs`), ``params`` whole and the same on every
    rank, ``opt_state`` the ``torch.optim.Optimizer`` over its leaves
    (``optimizer``, through ``training.create_train_state``), updated in
    place; the loss is replicated.

    ``halo_width``: the halo plan's B (``prepare_composed_inputs(halo=True)``;
    with ``scheduled_rounds``, the plan's total halo rows); the step then
    needs ``src_halo`` and ``send_idx``. ``neg_mode``: ``"local_roll"``
    (the default in halo mode; ``neg`` is this rank's rotation, drawn in
    ``[1, max(cap, 2))`` from ``gen`` when None) or ``"uniform_global"``
    (the default in the dense v1; ``neg`` the rank's block of uniform
    negatives over ``num_nodes``, drawn from ``gen`` when None). ``contrib``:
    ``"dense"`` (the all-relations product over the rank's rows),
    ``"grouped"`` (one product per relation group of the shard's sorted
    edges; needs ``rel_group_sizes``), or ``"pallas"`` / ``"pallas_packed"``
    / ``"cuda"``: the ``cuda`` backend over the shard's SortPlan (needs
    ``agg_sorted`` and ``kernel_plan``, ``group_pad=256``). ``agg_sorted``:
    the in-shard sum through the shard's host plan (``agg_plan``), degrees
    static. Dropout, when ``config.dropout > 0``, is per-rank row dropout
    drawn from ``gen`` after the negatives (a valid draw, not any single
    process's).
    """
    use_halo = halo_width is not None
    if neg_mode is None:
        neg_mode = "local_roll" if use_halo else "uniform_global"
    if neg_mode not in ("local_roll", "uniform_global"):
        raise ValueError(f"unknown neg_mode: {neg_mode!r}")
    if neg_mode == "local_roll" and not use_halo:
        raise ValueError(
            "neg_mode='local_roll' requires halo mode (halo_width set): "
            "local scoring reuses the halo plan's boundary exchange"
        )
    if contrib not in ("dense", "grouped") + KERNEL_CONTRIBS:
        raise ValueError(f"unknown contrib backend: {contrib!r}")
    if contrib in KERNEL_CONTRIBS and not agg_sorted:
        raise ValueError(
            f"contrib={contrib!r} needs agg_sorted=True (the kernel "
            "backends run on the per-shard SortPlan discipline; "
            "prepare_composed_inputs(rel_sort_local=True, group_pad=256))"
        )
    if contrib in KERNEL_CONTRIBS and not use_halo and mesh_axis_size(mesh, axis) > 1:
        # The shard's plan indexes dst by local row, which is the row of
        # the [local ++ halo] table but not of the dense v1's gathered
        # table on any rank but the first (JAX gathers rank 0's rows there).
        raise ValueError(f"contrib={contrib!r} on more than one rank needs halo mode "
                         "(halo_width set)")
    npp = nodes_per_shard

    def step(params, opt_state: torch.optim.Optimizer, feats, src, dst, rel, mask,
             chars, lens, gen: torch.Generator, src_halo=None, send_idx=None,
             rel_group_sizes=None, agg_plan=None, kernel_plan=None, neg=None
             ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        if use_halo and (src_halo is None or send_idx is None):
            raise ValueError("halo_width set: step needs src_halo and send_idx "
                             "(prepare_composed_inputs(halo=True))")
        if contrib == "grouped" and rel_group_sizes is None:
            raise ValueError("contrib='grouped' needs rel_group_sizes "
                             "(prepare_composed_inputs(rel_sort_local=True))")
        if agg_sorted and agg_plan is None:
            raise ValueError("agg_sorted=True: step needs agg_plan=(dst_perm, inv_perm, "
                             "dst_sorted, dst_splits, in_degree) from "
                             "prepare_composed_inputs")
        if contrib in KERNEL_CONTRIBS and kernel_plan is None:
            raise ValueError(f"contrib={contrib!r}: step needs kernel_plan "
                             "(prepare_composed_inputs(rel_sort_local=True, "
                             "group_pad=256).kernel_plan)")
        cap, dev = dst.shape[0], feats.device
        if neg is None and neg_mode == "local_roll":
            neg = torch.randint(1, max(cap, 2), (), generator=gen, device=dev)
        elif neg is None:
            neg = torch.randint(0, npp * mesh_axis_size(mesh, axis)
                                if num_nodes is None else num_nodes,
                                (cap,), generator=gen, device=dev, dtype=src.dtype)
        opt_state.zero_grad(set_to_none=True)
        p = tree_map(lambda t: copy(t, mesh, axis), params)
        exchange = (_halo_exchange(mesh, axis, send_idx, halo_width, scheduled_rounds)
                    if use_halo else _dense_exchange(mesh, axis))
        h = _composed_layers(
            mesh, config, p, npp, axis, feats, src_halo if use_halo else src, dst, rel,
            mask, chars, lens, exchange, halo=use_halo, contrib=contrib,
            sizes=None if rel_group_sizes is None else rel_group_sizes[0].tolist(),
            agg=agg_plan if agg_sorted else None,
            plan=(_local_plan(agg_plan, kernel_plan, npp)
                  if contrib in KERNEL_CONTRIBS else None),
            gen=gen if config.dropout > 0.0 else None,
        )
        if neg_mode == "local_roll":
            local_dst = _gather_rows(dst - axis_index(mesh, axis) * npp, npp)
            loss = _local_roll_loss(mesh, axis, h, exchange(h), src_halo, local_dst, mask,
                                    int(neg), margin)
        else:
            embs = _dense_exchange(mesh, axis)(h)
            head = embs.index_select(0, src)
            pos = (head * embs.index_select(0, dst)).sum(-1)
            neg_s = (head * embs.index_select(0, neg)).sum(-1)
            loss = _masked_mean((margin - pos + neg_s).clamp(min=0.0) * mask, mask,
                                mesh, axis)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def composed_forward(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    params: dict,
    inputs: ComposedInputs,
    *,
    axis: str = "edge",
) -> torch.Tensor:
    """Inference-mode composed forward (the dense v1 over ``inputs.src``'s
    global ids): this rank's ``[nodes_per_shard, H]`` rows of the
    embeddings. ``params`` are whole, on the device the rows are computed
    on; ``inputs`` is the whole host layout, whose blocks the rank picks."""
    dev = params["input_proj"]["w"].device
    (feats, src, dst, rel, mask, chars, lens), _ = local_inputs(inputs, mesh, axis, dev)
    p = tree_map(lambda t: copy(t, mesh, axis), params)
    return _composed_layers(mesh, config, p, inputs.nodes_per_shard, axis, feats, src,
                            dst, rel, mask, chars, lens, _dense_exchange(mesh, axis),
                            halo=False)
