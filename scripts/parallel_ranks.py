#!/usr/bin/env python3
"""``parallel/`` slices A and B across cards: one NCCL rank per card.

    python3 scripts/parallel_ranks.py [RANKS]

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
  and their peak memory.

Rank 0 prints one JSON line. Exits non-zero if a check fails.
"""

from __future__ import annotations

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

ATOL = 3e-5
DEFAULT_RANKS = 4


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


def run_rank(rank: int, world: int, tmp: str, backend: str = "nccl") -> None:
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
        res = dict(relation_sharded=dict(
            bitwise=all(torch.equal(banks[n], single[n]) for n in single),
            max_abs_err=gen_err,
            ms=cs.cuda_ms(lambda: cs.relation_sharded_generate(
                mesh, config.weight_generator, te, wg, _rank_rows(chars, mesh),
                _rank_rows(lens, mesh), axis="edge"), iters=5, warmup=1)))
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
        res["seconds"] = time.perf_counter() - t0
        everyone = [None] * world
        dist.all_gather_object(everyone, res)
        if rank == 0:
            _report(world, everyone, Path(tmp) / "report.json")
    finally:
        dist.destroy_process_group()


def _report(world: int, results: list, path: Path) -> None:
    """The slowest rank's times and the largest errors over ranks, printed
    and written to ``path`` for the parent process."""
    forms = ("edge_partitioned", "node_partitioned", "halo", "scheduled_halo")
    line = dict(ranks=world, card=cs.card_line(), plans=results[0]["plans"])
    failures = []
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
    line["seconds"] = max(r["seconds"] for r in results)
    line["failures"] = failures
    text = json.dumps(line)
    print(text, flush=True)
    path.write_text(text)


def main(world: int) -> int:
    if torch.cuda.device_count() < world:
        raise SystemExit(f"parallel_ranks.py: needs {world} CUDA cards, "
                         f"found {torch.cuda.device_count()}")
    cs.resolve_device(None)
    cs.native_bridge.get_native()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(run_rank, args=(world, tmp), nprocs=world, join=True,
                           start_method="spawn")
        line = json.loads((Path(tmp) / "report.json").read_text())
    return 1 if line["failures"] else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_RANKS))
