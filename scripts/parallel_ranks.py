#!/usr/bin/env python3
"""``parallel/`` across cards: one NCCL rank per card.

    python3 scripts/parallel_ranks.py [RANKS] [--only composed]

Run from the root of a checkout on a machine with RANKS (default 4) CUDA
cards joined by NVLink. It builds the kernels once, starts one process per
card, which meet through a ``file://`` path in a temporary directory, and
on each rank, at xl (``chip_smoke.py``'s graph and model, weights at scale
one):

- holds edge-partitioned, node-partitioned, halo and scheduled-halo
  message passing against the single-card main path (the ``cuda`` backend
  over the SortPlan) that every rank also computes: the rank's output
  rows and the gradients of ``Σ out · R`` (the rank's rows of h, and
  W_msg, W_self, bias whole) within the f32 gate, 3e-5 after dividing by
  max(1, max|reference|);
- compares relation-sharded generation (U_pad / RANKS rows a rank) with
  single-rank generation, bit for bit or by its largest difference;
- takes one data-parallel step over RANKS copies of the xl graph, one a
  rank, and holds its loss and gradients to the single-card step on the
  mean of the copies' losses (the gradients summed by NCCL in another
  order, so within the gate rather than bit for bit), and reports the
  parameters after Adam;
- times each form's forward + backward, the DP step and each form's
  exchange alone (CUDA events, each rank; the slowest rank is reported)
  and their peak memory;
- slices C and D: the composed step over RANKS shards of the xl halo
  layout (relation-sorted, group-padded per shard) with the ``cuda``
  contribution, held with uniform negatives to the single-card step on the
  same layout, then timed with local scoring beside its exchanges alone
  and the one-shard step in the same call; the 2D composed step on a
  (RANKS/2, 2) mesh against the 1D step on its edge axis; the pipeline
  over RANKS stages at xl widths with one layer a stage (num_layers =
  RANKS) and 4 microbatches, against the sequential forward and step;
- the distributed minibatch trainer (BASELINE.json #4 at
  benchmarks/minibatch_xxl.py's shapes: N=1M, E=10M, U=237, batch 1024,
  fanouts (10, 10), cap_multiple 8192; ``chip_smoke.py``'s graph and
  model): one step against the single-card ``MinibatchTrainer`` on the
  same batch, negatives and weights (the Adam-step gate), then 1 warm-up
  and 5 timed steps split into host sampling, partition and ladder,
  host-to-device copies and the device step, and the dense v1's
  all-gathers alone (a layer's h and banks).

Rank 0 prints one JSON line. Exits non-zero if a check fails. With
``--only composed`` the ranks run the composed step's phase alone (its
checks, its times and the k = 1 step beside it).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.parallel import collectives as coll  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.parallel.composed_tp import (  # noqa: E402
    composed_tp_param_specs,
)
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import local_shard  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.utils import profiling  # noqa: E402

ATOL = 3e-5
DEFAULT_RANKS = 4
# The pipeline's microbatches: with S = RANKS stages, T = M + S - 1 ticks.
PIPE_RANKS_MICRO = 4


def _rank_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    return coll.local_block(t, mesh, "edge")


def _forms(dev, mesh, k, g, inputs, r, ref) -> dict:
    """Each form on this rank against the main path's ``ref`` =
    ``(out, grads)``; ms per forward + backward, the exchange alone."""
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
    host = [np.asarray(a) for a in g.arrays[:4]]
    me = coll.axis_index(mesh, "edge")
    node = cs.partition_edges_by_dst(*host, cs.XL_N, k)
    npp = node[4]
    node_t = [_rank_rows(torch.as_tensor(a, device=dev), mesh) for a in node[:4]]
    plan = cs.halo.build_halo_plan(*host, cs.XL_N, k)
    plan_t = [_rank_rows(torch.as_tensor(a, device=dev), mesh) for a in plan.edge_arrays]
    send_idx = _rank_rows(torch.as_tensor(plan.send_idx, device=dev), mesh)
    sched = cs.halo.build_scheduled_halo_plan(*host, cs.XL_N, k)
    tables = [torch.as_tensor(t[me:me + 1], device=dev) for t in sched.send_tables]
    h, wm, ws, b = inputs
    rows = slice(me * npp, (me + 1) * npp)
    blk = lambda a: _rank_rows(a, mesh)  # noqa: E731
    forms = {
        "edge_partitioned": (
            lambda h, wm, ws, b: cs.edge_partitioned_message_passing(
                mesh, h, blk(src), blk(dst), blk(rel), wm, ws, b, edge_mask=blk(mask)),
            False,
            lambda: coll.psum(torch.zeros(cs.XL_N, 2 * cs.WIDTH + 1, device=dev), mesh,
                              "edge")),
        "node_partitioned": (
            lambda h, wm, ws, b: cs.node_partitioned_message_passing(
                mesh, h, *node_t[:3], wm, ws, b, node_t[3], npp),
            True,
            lambda: coll.all_gather(h[rows], mesh, "edge")),
        "halo": (
            lambda h, wm, ws, b: cs.halo.halo_message_passing(
                mesh, h, plan_t, send_idx, wm, ws, b, plan.nodes_per_shard,
                plan.halo_width),
            True,
            lambda: coll.all_to_all(
                h[rows][send_idx[0].reshape(-1).long()].reshape(k, plan.halo_width, -1),
                mesh, "edge")),
        "scheduled_halo": (
            lambda h, wm, ws, b: cs.halo.scheduled_halo_message_passing(
                mesh, h, sched, wm, ws, b),
            True,
            lambda: cs.halo.scheduled_halo_exchange(mesh, h[rows], tables,
                                                    sched.round_perms)),
    }
    want_out, want_grads = ref
    out = {}
    for name, (fn, per_rank, exchange) in forms.items():
        args = [h[rows] if per_rank else h, wm, ws, b]
        r_used = r[rows] if per_rank else r
        torch.cuda.reset_peak_memory_stats(dev)
        got, grads = cs._grad_run(fn, args, r_used)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        err = (got - (want_out[rows] if per_rank else want_out)).abs().max().item()
        grad_errs = {
            n: cs.scaled_err(a, w[rows] if (n == "h" and per_rank) else w)
            for n, a, w in zip(("h", "W_msg", "W_self", "bias"), grads, want_grads)}
        del got, grads
        ms = cs.cuda_ms(lambda fn=fn, args=args, r_used=r_used: cs._grad_run(fn, args, r_used),
                        iters=3, warmup=1)
        exchange_ms = cs.cuda_ms(exchange, iters=10, warmup=2)
        out[name] = dict(max_abs_err=err, grad_scaled_err=grad_errs, ms=ms,
                         exchange_ms=exchange_ms, peak_memory_gb=peak)
        torch.cuda.empty_cache()
    out["plans"] = dict(halo_width=plan.halo_width, rounds=sched.num_rounds,
                        nodes_per_shard=npp)
    return out


def _dp(dev, mesh, k, feats_np, g) -> dict:
    """One DP step over k xl copies (one a rank) against the single-card
    step on the mean of the copies' losses."""
    config = cs.train_config()
    init = cs.init_hypergnn(config, torch.Generator().manual_seed(3))
    gen = torch.Generator(device=dev).manual_seed(4)
    arrays = [torch.as_tensor(np.stack([a] * k), device=dev) for a in g.arrays]
    feats = torch.as_tensor(np.stack([feats_np] * k), device=dev)
    neg = torch.randint(0, cs.XL_N, arrays[0].shape, generator=gen, device=dev,
                        dtype=arrays[0].dtype)

    def fresh():
        return cs.create_train_state(cs.tree_map(lambda t: t.to(dev), init),
                                     cs.adam(cs.LEARNING_RATE))

    dp, ref = fresh(), fresh()
    step = cs.make_data_parallel_step(mesh, config, cs.adam(cs.LEARNING_RATE), axis="edge")
    local = [_rank_rows(a, mesh) for a in [feats] + arrays]
    _, _, loss = step(dp.params, dp.opt_state, *local, gen, neg=_rank_rows(neg, mesh))
    ref.opt_state.zero_grad(set_to_none=True)
    ref_loss = sum(
        cs.link_prediction_loss(
            cs.apply_hypergnn(config, ref.params, feats[i], *(a[i] for a in arrays)),
            arrays[0][i], arrays[1][i], neg[i], edge_mask=arrays[3][i])
        for i in range(k)) / k
    ref_loss.backward()
    ref.opt_state.step()
    pairs = list(zip((t for _, t in cs.named_leaves(dp.params)),
                     (t for _, t in cs.named_leaves(ref.params))))
    grad_err = max(cs.scaled_err(a.grad, w.grad) for a, w in pairs)
    diffs = torch.cat([(a.detach() - w.detach()).abs().flatten() for a, w in pairs])
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cs.cuda_ms(lambda: step(dp.params, dp.opt_state, *local, gen,
                                 neg=_rank_rows(neg, mesh)), iters=2, warmup=0)
    return dict(loss=loss.item(), loss_err=abs(loss.item() - ref_loss.item()),
                grad_scaled_err=grad_err, param_max_err=diffs.max().item(),
                params_within_gate=(diffs <= ATOL).float().mean().item(), ms=ms,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def _composed(dev, mesh, k, feats_np, g) -> dict:
    """The composed step at k ranks on the xl halo layout, relation-sorted
    and group-padded per shard: with uniform negatives and the cuda
    contribution against the single-card step on the same layout and
    negatives (the ``dense`` backend over the whole layout); then, with
    local scoring (the production form), its ms per step, its launches, the
    exchanges alone, and the k = 1 step (every rank the whole graph, a
    ("edge", "data") mesh of (1, k)) in the same call."""
    config = cs.train_config()
    init = cs._scale_one(cs.init_hypergnn(config, torch.Generator().manual_seed(8)))
    t0 = time.perf_counter()
    inputs = cs.prepare_composed_inputs(g, feats_np, k, halo=True, rel_sort_local=True,
                                        group_pad=256)
    prep_ms = (time.perf_counter() - t0) * 1e3
    arrays, kw = cs.local_inputs(inputs, mesh, "edge", dev)
    whole = [torch.as_tensor(np.asarray(a), device=dev) for a in (
        inputs.feats, inputs.src, inputs.dst, inputs.rel_ids, inputs.edge_mask,
        inputs.char_ids, inputs.lengths)]
    gen = torch.Generator(device=dev).manual_seed(9)
    neg = torch.randint(0, cs.XL_N, whole[1].shape, generator=gen, device=dev,
                        dtype=whole[1].dtype)
    step = cs.composed_step(mesh, config, inputs, "pallas", local_roll=False)
    state = cs._fresh(init, dev)
    _, _, loss = step(state.params, state.opt_state, *arrays, gen, neg=_rank_rows(neg, mesh),
                      **kw)
    ref = cs._fresh(init, dev)
    ref_config = dataclasses.replace(config, backend="dense", rel_sorted=False,
                                     group_padded=False)
    ref.opt_state.zero_grad(set_to_none=True)
    ref_loss = cs.link_prediction_loss(
        cs.apply_hypergnn(ref_config, ref.params, *whole), whole[1], whole[2], neg,
        edge_mask=whole[4])
    ref_loss.backward()
    ref.opt_state.step()
    res = dict(uniform=cs.adam_step_errors(
        f"composed k={k} uniform_global contrib=pallas vs the single-card step", loss,
        state.params, ref_loss, ref.params))
    del state, ref
    torch.cuda.empty_cache()

    shift = 1 + int(torch.randint(0, arrays[1].shape[0] - 1, (), generator=gen, device=dev))
    step = cs.composed_step(mesh, config, inputs, "pallas", local_roll=True)
    state = cs._fresh(init, dev)
    step(state.params, state.opt_state, *arrays, gen, neg=shift, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    with profiling.tally() as counts:
        ms = cs._events_ms(lambda: step(state.params, state.opt_state, *arrays, gen, neg=shift,
                                        **kw), cs.COMPOSED_TIMED)
    launches = {n: c // cs.COMPOSED_TIMED for n, c in cs.kernel_launches(counts).items()}
    res["local_roll"] = dict(ms=ms, launches_per_step=launches,
                             launches_as_counted=launches == cs.COMPOSED_LAUNCHES,
                             run_table_launches=counts.get("kernel.run_table", 0),
                             peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    # Where the step's time goes: its device time against its wall time.
    res["profile"] = cs.profile_device(f"composed k={k} step", lambda: step(
        state.params, state.opt_state, *arrays, gen, neg=shift, **kw), rows=8)
    # The exchanges alone: a layer's halo all_to_all, its three bank
    # all_gathers, and the all_reduce of every parameter's gradient.
    h = torch.randn(inputs.nodes_per_shard, cs.WIDTH, device=dev)
    send = kw["send_idx"]
    u_loc = arrays[5].shape[0]
    banks = [torch.randn(u_loc, cs.WIDTH, cs.WIDTH, device=dev),
             torch.randn(u_loc, cs.WIDTH, cs.WIDTH, device=dev),
             torch.randn(u_loc, cs.WIDTH, device=dev)]
    n_params = sum(t.numel() for _, t in cs.named_leaves(init))
    flat = torch.randn(n_params, device=dev)
    res["exchange_ms"] = dict(
        halo_all_to_all=cs.cuda_ms(lambda: coll.all_to_all(
            h.index_select(0, send[0].reshape(-1)).reshape(k, inputs.halo_width, -1),
            mesh, "edge"), iters=10, warmup=2),
        bank_all_gathers=cs.cuda_ms(lambda: [coll.all_gather(b, mesh, "edge") for b in banks],
                                    iters=10, warmup=2),
        gradient_all_reduce=cs.cuda_ms(lambda: coll.psum(flat, mesh, "edge"), iters=10,
                                       warmup=2))
    del state
    torch.cuda.empty_cache()

    one = cs.make_mesh((1, k), ("edge", "data"), device_type=dev.type)
    inputs1 = cs.prepare_composed_inputs(g, feats_np, 1, halo=True, rel_sort_local=True,
                                         group_pad=256)
    arrays1, kw1 = cs.local_inputs(inputs1, one, "edge", dev)
    step1 = cs.composed_step(one, config, inputs1, "pallas", local_roll=True)
    state = cs._fresh(init, dev)
    step1(state.params, state.opt_state, *arrays1, gen, neg=shift, **kw1)
    res["k1_ms"] = cs._events_ms(lambda: step1(state.params, state.opt_state, *arrays1, gen,
                                               neg=shift, **kw1), cs.COMPOSED_TIMED)
    res["k1_profile"] = cs.profile_device("composed k=1 step", lambda: step1(
        state.params, state.opt_state, *arrays1, gen, neg=shift, **kw1), rows=8)
    res["prepare_ms"] = prep_ms
    res["cap"] = int(arrays[1].shape[0])
    res["halo_width"] = int(inputs.halo_width)
    del state
    torch.cuda.empty_cache()
    return res


def _composed_tp(dev, k, feats_np, g) -> dict:
    """The 2D composed step on a (k/2, 2) ("edge", "model") mesh (grouped,
    halo, local scoring) against the 1D composed step on its edge axis,
    from the same parameters and rotations; ms of both."""
    config = cs.train_config()
    init = cs._scale_one(cs.init_hypergnn(config, torch.Generator().manual_seed(8)))
    mesh2 = cs.make_mesh((k // 2, 2), ("edge", "model"), device_type=dev.type)
    inputs = cs.prepare_composed_inputs(g, feats_np, k // 2, halo=True, rel_sort_local=True)
    arrays, kw = cs.local_inputs(inputs, mesh2, "edge", dev)
    kw = cs.composed_kwargs(kw, "grouped")
    gen = torch.Generator(device=dev).manual_seed(10 + coll.axis_index(mesh2, "edge"))
    shift = 777
    one_d = cs._fresh(init, dev)
    step1 = cs.composed_step(mesh2, config, inputs, "grouped", local_roll=True)
    _, _, ref_loss = step1(one_d.params, one_d.opt_state, *arrays, gen, neg=shift, **kw)
    two_d = cs.create_train_state(cs.shard_composed_tp_params(
        cs.tree_map(lambda t: t.to(dev, copy=True), init), config, mesh2),
        cs.adam(cs.LEARNING_RATE))
    step2 = cs.make_composed_tp_train_step(
        mesh2, config, cs.adam(cs.LEARNING_RATE), inputs.nodes_per_shard,
        halo_width=inputs.halo_width, contrib="grouped")
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, loss = step2(two_d.params, two_d.opt_state, *arrays, gen, neg=shift, **kw)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    specs = dict(cs.named_leaves(composed_tp_param_specs(config, mesh2)))
    want = {}
    for path, t in cs.named_leaves(one_d.params):
        want[path] = local_shard(t.detach(), specs[path], mesh2).clone()
        want[path].grad = local_shard(t.grad, specs[path], mesh2).clone()
    res = cs.adam_step_errors(f"composed_tp {k // 2}x2 vs the 1D composed step", loss,
                              two_d.params, ref_loss, want)
    res["ms_2d"] = cs._events_ms(lambda: step2(two_d.params, two_d.opt_state, *arrays, gen,
                                               neg=shift, **kw), 2)
    res["ms_1d"] = cs._events_ms(lambda: step1(one_d.params, one_d.opt_state, *arrays, gen,
                                               neg=shift, **kw), 2)
    res["peak_memory_gb"] = peak
    del one_d, two_d
    torch.cuda.empty_cache()
    return res


def _pipeline(dev, k, feats_np, g) -> dict:
    """The GPipe pipeline over k stages, one layer a stage (num_layers = k,
    xl widths), PIPE_RANKS_MICRO xl microbatches: the forward against
    ``apply_hypergnn`` per microbatch and the train step against the
    sequential step on the same negatives; ms, the ring hop alone."""
    config = dataclasses.replace(cs.train_config("auto"), num_layers=k)
    mesh_p = cs.make_mesh((k,), ("pipe",), device_type=dev.type)
    init = cs.init_hypergnn(config, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    feats = torch.as_tensor(np.stack([feats_np] + [
        rng.standard_normal(feats_np.shape).astype(np.float32)
        for _ in range(PIPE_RANKS_MICRO - 1)]), device=dev)
    arrays = [torch.as_tensor(np.stack([a] * PIPE_RANKS_MICRO), device=dev) for a in g.arrays]
    params = cs.tree_map(lambda t: t.to(dev), init)
    with torch.no_grad():
        out = cs.pipelined_forward(mesh_p, config, params, feats, *arrays)
        fwd_err = max((out[m] - cs.apply_hypergnn(config, params, feats[m],
                                                  *(a[m] for a in arrays))).abs().max().item()
                      for m in range(PIPE_RANKS_MICRO))
        del out
        fwd_ms = cs.cuda_ms(lambda: cs.pipelined_forward(mesh_p, config, params, feats,
                                                         *arrays), iters=2, warmup=1)
        seq_ms = cs.cuda_ms(lambda: [cs.apply_hypergnn(config, params, feats[m],
                                                       *(a[m] for a in arrays))
                                     for m in range(PIPE_RANKS_MICRO)], iters=2, warmup=1)
    gen = torch.Generator(device=dev).manual_seed(6)
    neg = torch.randint(0, cs.XL_N, arrays[0].shape, generator=gen, device=dev,
                        dtype=arrays[0].dtype)
    pipe, ref = cs._fresh(init, dev), cs._fresh(init, dev)
    step = cs.make_pipelined_train_step(mesh_p, config, cs.adam(cs.LEARNING_RATE))
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, loss = step(pipe.params, pipe.opt_state, feats, *arrays, gen, neg_dst=neg)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ref.opt_state.zero_grad(set_to_none=True)
    ref_loss = torch.stack([
        cs.link_prediction_loss(cs.apply_hypergnn(config, ref.params, feats[m],
                                                  *(a[m] for a in arrays)),
                                arrays[0][m], arrays[1][m], neg[m], edge_mask=arrays[3][m])
        for m in range(PIPE_RANKS_MICRO)]).mean()
    ref_loss.backward()
    ref.opt_state.step()
    res = cs.adam_step_errors(f"pipeline S={k} vs the sequential step", loss, pipe.params,
                              ref_loss, ref.params)
    res.update(
        forward_max_abs_err=fwd_err, forward_ms=fwd_ms, sequential_forward_ms=seq_ms,
        step_ms=cs._events_ms(lambda: step(pipe.params, pipe.opt_state, feats, *arrays, gen,
                                           neg_dst=neg), 2),
        ring_hop_ms=cs.cuda_ms(lambda: coll.ppermute(
            feats[0], mesh_p, "pipe",
            [(i, (i + 1) % k) for i in range(k)]), iters=10, warmup=2),
        peak_memory_gb=peak, microbatches=PIPE_RANKS_MICRO, layers=k)
    del pipe, ref
    torch.cuda.empty_cache()
    return res


def _distributed_minibatch(dev, mesh, k) -> dict:
    """``DistributedMinibatchTrainer`` over k ranks at the xxl config: one
    step against the single-card trainer's ``device_step`` on the same
    batch and negatives (every rank computes it on its card), then the
    timed steps split by stage, the dense v1's all-gathers alone, peak
    memory and the kernel launches (none: ``grouped``)."""
    t0 = time.perf_counter()
    ei, etexts, feats = cs.mb_graph(cs.MB_N, cs.MB_E, cs.MB_U)
    graph_s = time.perf_counter() - t0
    config, spec = cs.mb_config(), cs.MinibatchSpec(**cs.MB_SPEC)
    init = cs.init_hypergnn(config, torch.Generator().manual_seed(0))
    trainer = cs.DistributedMinibatchTrainer(mesh, config, cs.adam(cs.LEARNING_RATE), ei,
                                             etexts, feats, spec,
                                             cap_multiple=cs.MB_CAP_MULTIPLE, device=dev)
    single = cs.MinibatchTrainer(config, cs.adam(cs.LEARNING_RATE), ei, etexts, feats, spec,
                                 device=dev)
    batch = trainer.sample_batch(np.random.default_rng(3))
    neg = torch.as_tensor(np.random.default_rng(4).integers(
        0, batch[0].shape[0], spec.batch_size).astype(np.int32), device=dev)
    ref = cs._fresh(init, dev)
    _, _, ref_loss = single.device_step(ref.params, ref.opt_state, single.to_device(batch),
                                        neg_dst=neg)
    state = cs._fresh(init, dev)
    _, _, loss = trainer.device_step(state.params, state.opt_state,
                                     trainer.to_device(trainer.shard_batch(batch)),
                                     neg_dst=neg)
    res = dict(step=cs.adam_step_errors(
        f"distributed minibatch k={k} vs the single-card MinibatchTrainer", loss,
        state.params, ref_loss, ref.params))
    del ref, state, single
    torch.cuda.empty_cache()

    state = cs._fresh(init, dev)
    rng_np, gen = np.random.default_rng(1), torch.Generator(device=dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats(dev)
    with profiling.tally() as counts:
        steps = cs.dist_minibatch_steps(f"distributed minibatch k={k} rank {dist.get_rank()}",
                                        trainer, state, rng_np, gen, dev, cs.MB_TIMED)
    res.update(cs.medians(steps[1:]), steps=steps, graph_s=graph_s,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches=cs.kernel_launches(counts))
    # The dense v1's exchanges alone: a layer's all-gather of h and of the
    # three banks' rows.
    npp, u_loc = steps[-1]["nodes_per_shard"], steps[-1]["relations_padded"] // k
    h = torch.randn(npp, cs.WIDTH, device=dev)
    banks = [torch.randn(u_loc, cs.WIDTH, cs.WIDTH, device=dev),
             torch.randn(u_loc, cs.WIDTH, cs.WIDTH, device=dev),
             torch.randn(u_loc, cs.WIDTH, device=dev)]
    res["exchange_ms"] = dict(
        h_all_gather=cs.cuda_ms(lambda: coll.all_gather(h, mesh, "edge"), iters=10, warmup=2),
        bank_all_gathers=cs.cuda_ms(lambda: [coll.all_gather(b, mesh, "edge") for b in banks],
                                    iters=10, warmup=2))
    del state, trainer
    torch.cuda.empty_cache()
    return res


def run_rank(rank: int, world: int, tmp: str, backend: str = "nccl",
             only: str | None = None) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = cs.resolve_device(torch.device("cuda", rank))
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        mesh = cs.make_mesh((world,), ("edge",), device_type=dev.type)
        t0 = time.perf_counter()
        feats_np, g = cs.xl_graph()
        res = {}
        if only != "composed":
            config = cs.train_config()
            params = cs.tree_map(lambda t: t.to(dev), cs._scale_one(
                cs.init_hypergnn(config, torch.Generator().manual_seed(0))))
            chars, lens = (torch.as_tensor(a, device=dev) for a in g.arrays[4:6])
            te, wg = params["text_encoder"], params["weight_generators"][0]
            single = cs.apply_weight_generator(config.weight_generator, wg,
                                               cs.apply_text_encoder(te, chars, lens))
            banks = cs.relation_sharded_generate(
                mesh, config.weight_generator, te, wg, _rank_rows(chars, mesh),
                _rank_rows(lens, mesh), axis="edge")
            gen_err = max((banks[n] - single[n]).abs().max().item() for n in single)
            res["relation_sharded"] = dict(
                bitwise=all(torch.equal(banks[n], single[n]) for n in single),
                max_abs_err=gen_err,
                ms=cs.cuda_ms(lambda: cs.relation_sharded_generate(
                    mesh, config.weight_generator, te, wg, _rank_rows(chars, mesh),
                    _rank_rows(lens, mesh), axis="edge"), iters=5, warmup=1))
            rgen = torch.Generator().manual_seed(1)
            h = torch.randn(cs.XL_N, cs.WIDTH, generator=rgen).to(dev)
            r = torch.randn(cs.XL_N, cs.WIDTH, generator=rgen).to(dev)
            inputs = [h, banks["W_msg"].detach(), banks["W_self"].detach(),
                      banks["bias"].detach()]
            src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
            plan = g.sort_plan.to(dev)
            ref = cs._grad_run(lambda h, wm, ws, b: cs.relational_message_passing(
                h, src, dst, rel, wm, ws, b, num_nodes=cs.XL_N, edge_mask=mask,
                backend="cuda", rel_sorted=True, group_padded=True, sort_plan=plan), inputs, r)
            res.update(_forms(dev, mesh, world, g, inputs, r, ref))
            del ref, banks, inputs
            torch.cuda.empty_cache()
            res["data_parallel"] = _dp(dev, mesh, world, feats_np, g)
            torch.cuda.empty_cache()
        res["composed"] = _composed(dev, mesh, world, feats_np, g)
        if only != "composed":
            res["composed_tp"] = _composed_tp(dev, world, feats_np, g)
            res["pipeline"] = _pipeline(dev, world, feats_np, g)
            del feats_np, g
            res["distributed_minibatch"] = _distributed_minibatch(dev, mesh, world)
        res["seconds"] = time.perf_counter() - t0
        everyone = [None] * world
        dist.all_gather_object(everyone, res)
        if rank == 0:
            _report(world, everyone, Path(tmp) / "report.json")
    finally:
        dist.destroy_process_group()


def _report(world: int, results: list, path: Path) -> None:
    """The slowest rank's times and the largest errors over ranks, printed
    and written to ``path`` for the parent process (the composed step's
    alone where the ranks ran only it)."""
    line = dict(ranks=world, card=cs.card_line())
    failures = []

    def worst(entries, key):
        return max(e[key] for e in entries)

    step_keys = ("loss_err", "grad_scaled_err", "param_scaled_err", "param_max_err")
    gates = dict(loss_err=cs.STEP_LOSS_ATOL, grad_scaled_err=ATOL, param_scaled_err=ATOL,
                 param_max_err=2 * cs.LEARNING_RATE)
    if "data_parallel" in results[0]:
        _report_other_phases(results, line, failures, worst, step_keys, gates)
    comp = [r["composed"] for r in results]
    line["composed"] = dict(
        uniform={key: worst([c["uniform"] for c in comp], key) for key in step_keys},
        local_roll=dict(
            ms=worst([c["local_roll"] for c in comp], "ms"),
            peak_memory_gb=worst([c["local_roll"] for c in comp], "peak_memory_gb"),
            launches_per_step=comp[0]["local_roll"]["launches_per_step"],
            launches_as_counted=all(c["local_roll"]["launches_as_counted"] for c in comp),
            run_table_launches=worst([c["local_roll"] for c in comp], "run_table_launches")),
        exchange_ms={key: worst([c["exchange_ms"] for c in comp], key)
                     for key in comp[0]["exchange_ms"]},
        k1_ms=worst(comp, "k1_ms"), prepare_ms=worst(comp, "prepare_ms"),
        profile=comp[0]["profile"], k1_profile=comp[0]["k1_profile"],
        cap=comp[0]["cap"], halo_width=comp[0]["halo_width"])
    if any(line["composed"]["uniform"][key] > tol for key, tol in gates.items()):
        failures.append("composed")
    local = line["composed"]["local_roll"]
    if not local["launches_as_counted"] or local["run_table_launches"]:
        failures.append("composed_launches")
    line["seconds"] = max(r["seconds"] for r in results)
    line["failures"] = failures
    text = json.dumps(line)
    print(text, flush=True)
    path.write_text(text)


def _report_other_phases(results, line, failures, worst, step_keys, gates) -> None:
    """Every phase but the composed step's into ``line``, and the names of
    those that failed their gates into ``failures``."""
    forms = ("edge_partitioned", "node_partitioned", "halo", "scheduled_halo")
    line["plans"] = results[0]["plans"]
    for name in forms:
        rs = [r[name] for r in results]
        entry = dict(
            max_abs_err=max(r["max_abs_err"] for r in rs),
            grad_scaled_err={n: max(r["grad_scaled_err"][n] for r in rs)
                             for n in rs[0]["grad_scaled_err"]},
            ms=max(r["ms"] for r in rs), exchange_ms=max(r["exchange_ms"] for r in rs),
            peak_memory_gb=max(r["peak_memory_gb"] for r in rs))
        line[name] = entry
        if entry["max_abs_err"] > ATOL or max(entry["grad_scaled_err"].values()) > ATOL:
            failures.append(name)
    gen = [r["relation_sharded"] for r in results]
    line["relation_sharded"] = dict(bitwise=all(g["bitwise"] for g in gen),
                                    max_abs_err=max(g["max_abs_err"] for g in gen),
                                    ms=max(g["ms"] for g in gen))
    if line["relation_sharded"]["max_abs_err"] > 1e-6:
        failures.append("relation_sharded")
    dps = [r["data_parallel"] for r in results]
    line["data_parallel"] = dict(
        loss=dps[0]["loss"], loss_err=max(d["loss_err"] for d in dps),
        grad_scaled_err=max(d["grad_scaled_err"] for d in dps),
        param_max_err=max(d["param_max_err"] for d in dps),
        params_within_gate=min(d["params_within_gate"] for d in dps),
        ms=max(d["ms"] for d in dps), peak_memory_gb=max(d["peak_memory_gb"] for d in dps))
    if line["data_parallel"]["loss_err"] > 1e-5 or line["data_parallel"]["grad_scaled_err"] > ATOL:
        failures.append("data_parallel")
    tps = [r["composed_tp"] for r in results]
    line["composed_tp"] = {key: worst(tps, key)
                           for key in step_keys + ("ms_2d", "ms_1d", "peak_memory_gb")}
    pipes = [r["pipeline"] for r in results]
    line["pipeline"] = {key: worst(pipes, key) for key in step_keys + (
        "forward_max_abs_err", "forward_ms", "sequential_forward_ms", "step_ms", "ring_hop_ms",
        "peak_memory_gb")}
    line["pipeline"].update(microbatches=PIPE_RANKS_MICRO, layers=len(results))
    for name in ("composed_tp", "pipeline"):
        if any(line[name][key] > tol for key, tol in gates.items()):
            failures.append(name)
    if line["pipeline"]["forward_max_abs_err"] > ATOL:
        failures.append("pipeline_forward")
    mbs = [r["distributed_minibatch"] for r in results]
    line["distributed_minibatch"] = dict(
        step={key: worst([m["step"] for m in mbs], key) for key in step_keys},
        **{key: worst(mbs, key) for key in mbs[0] if key.startswith("median_")},
        exchange_ms={key: worst([m["exchange_ms"] for m in mbs], key)
                     for key in mbs[0]["exchange_ms"]},
        peak_memory_gb=worst(mbs, "peak_memory_gb"), graph_s=worst(mbs, "graph_s"),
        contribs=sorted({s["contrib"] for m in mbs for s in m["steps"]}),
        launches={name: sum(m["launches"][name] for m in mbs) for name in mbs[0]["launches"]},
        buckets=max(m["steps"][-1]["buckets"] for m in mbs),
        per_rank=[{key: m[key] for key in m if key.startswith("median_")} for m in mbs],
        rank0_steps=mbs[0]["steps"])
    if any(line["distributed_minibatch"]["step"][key] > tol for key, tol in gates.items()):
        failures.append("distributed_minibatch")
    if any(line["distributed_minibatch"]["launches"].values()):
        failures.append("distributed_minibatch_launches")


def main(world: int, only: str | None = None) -> int:
    if torch.cuda.device_count() < world:
        raise SystemExit(f"parallel_ranks.py: needs {world} CUDA cards, "
                         f"found {torch.cuda.device_count()}")
    cs.resolve_device(None)
    cs.native_bridge.get_native()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(run_rank, args=(world, tmp, "nccl", only), nprocs=world,
                           join=True, start_method="spawn")
        line = json.loads((Path(tmp) / "report.json").read_text())
    return 1 if line["failures"] else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        if only != "composed":
            raise SystemExit(f"parallel_ranks.py: --only takes 'composed', not {only!r}")
        del args[i: i + 2]
    sys.exit(main(int(args[0]) if args else DEFAULT_RANKS, only))
