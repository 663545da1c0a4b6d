"""Full-graph training: one training step object, driven back to back.

Set-up draws the graph and the weights from the seed, encodes the graph,
builds the port's step (``make_train_step``) with its Adam state, and
drives it through the mix's checked steps, reading the loss of each, the
first gradient from Adam's first moment, and the change of every leaf
after the last. The window then drives that same object, one step after
another with negatives drawn on the device from the seed, and ends with a
synchronise after the last step. Once it has closed, the program's state is
freed and the plain reference follows the checked steps from the same
weights and negatives.
"""

from __future__ import annotations

import gc
import itertools
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpubench import compare, graphs, port, trace
from gpubench.reference import hypergnn as ref

ADAM_B1 = 0.9
# At most 2**3 - 1 extra reference runs; more hinges near the kink than
# this are flipped all at once.
MOST_FLIPPED = 3


def shapes(model: dict, enc) -> dict:
    plan = enc.sort_plan
    return dict(rows=int(enc.src.shape[0]), num_nodes=int(enc.num_nodes),
                num_edges=int(enc.num_edges), num_rel=int(enc.num_relations),
                num_rel_pad=int(enc.char_ids.shape[0]),
                visited_rel=int(np.count_nonzero(np.diff(plan.tile_splits))))


class Feed:
    """The negatives of each step, drawn on the device from the seed: a
    rotation shift in [1, rows) for ``roll``, else a uniform tail for every
    layout row (the pad rows' are masked out of the loss)."""

    def __init__(self, seed: int, rows: int, num_nodes: int, roll: bool, device):
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.rows, self.num_nodes, self.roll, self.device = rows, num_nodes, roll, device

    def __call__(self) -> torch.Tensor:
        if self.roll:
            return torch.randint(1, self.rows, (), generator=self.gen, device=self.device)
        return torch.randint(0, self.num_nodes, (self.rows,), generator=self.gen,
                             device=self.device, dtype=torch.int32)


def reference_steps(reference, cell, weights, feats_np, graph, checked, **kwargs):
    """The reference's run of the checked steps from the same weights and
    negatives (a uniform step's tails taken at each raw edge's layout row)."""
    if cell.mix["neg_mode"] == "roll":
        negs = [int(k) for k in checked]
    else:
        raw_rows = torch.as_tensor(graph.rows, device=graph.device)
        negs = [neg.long()[raw_rows] for neg in checked]
    feats = torch.as_tensor(feats_np, device=graph.device)
    return ref.train_steps(reference, weights, feats, graph, negs,
                           neg_mode=cell.mix["neg_mode"], margin=cell.config["train"]["margin"],
                           lr=cell.config["train"]["lr"], **kwargs)


def flipped_runs(run_steps, want: dict) -> list:
    """``run_steps(flip=...)`` once for every nonempty set of the positives
    that ``want`` (a reference run) has near the kink, or, where there are
    more than ``MOST_FLIPPED`` of them, once with all of them flipped."""
    near = [(step, i) for step, rows in enumerate(want["near_kink"], start=1) for i in rows]
    sets = ([c for k in range(1, len(near) + 1) for c in itertools.combinations(near, k)]
            if len(near) <= MOST_FLIPPED else [tuple(near)])
    return [run_steps(flip=frozenset(c)) for c in sets] if near else []


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> SimpleNamespace:
    model, train_cfg, mix = cell.config["model"], cell.config["train"], cell.mix
    roll = mix["neg_mode"] == "roll"
    spans = trace.Spans(t_start)
    feats_np, ei, etexts = graphs.draw(cell.config["graph"], seed, model["node_feat_dim"])
    num_nodes = feats_np.shape[0]
    spans.mark("graph drawn")
    enc = port.encode(model, ei, etexts, num_nodes)
    spans.mark("graph encoded")
    rows = int(enc.src.shape[0])
    weights = ref.draw_params(model, seed, device)
    state = port.train.create_train_state(
        port.nest({k: v.clone().requires_grad_(True) for k, v in weights.items()}),
        port.train.adam(train_cfg["lr"]))
    step = port.train.make_train_step(port.config(model), margin=train_cfg["margin"],
                                      neg_mode=mix["neg_mode"])
    feats = torch.as_tensor(feats_np, device=device)
    arrays = [torch.as_tensor(a, device=device) for a in enc.arrays]
    plan = enc.sort_plan.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    negatives = Feed(seed, rows, num_nodes, roll, device)

    def one_step(neg):
        with spans("step"):
            _, _, loss = step(state.params, state.opt_state, feats, *arrays, gen,
                              neg_dst=neg, sort_plan=plan)
        return loss

    spans.mark("step built, inputs on the device")
    leaves = list(port.named_leaves(state.params))
    checked = [negatives() for _ in range(mix["checked_steps"])]
    losses, grad_norms = [], {}
    for k, neg in enumerate(checked):
        losses.append(one_step(neg))
        if k == 0:
            for path, leaf in leaves:
                moment = state.opt_state.state.get(leaf, {}).get("exp_avg")
                grad_norms[path] = 0.0 if moment is None else (moment / (1 - ADAM_B1)).norm()
    change_norms = {path: (leaf.detach() - weights[path]).norm() for path, leaf in leaves}
    prog = dict(losses=[float(v) for v in losses],
                grad_norms={k: float(v) for k, v in grad_norms.items()},
                change_norms={k: float(v) for k, v in change_norms.items()})
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    spans.mark("checked steps")
    spans.seconds.clear()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one_step(negatives())
        steps += 1
    sync()
    window_s = time.perf_counter() - t0
    span_ms = spans.means_ms()

    profiled = None
    if traced:
        n = mix["profiled_steps"]
        profiled = trace.profile(lambda: [one_step(negatives()) for _ in range(n)], n, spans)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    layout = shapes(model, enc)
    del state, step, feats, arrays, plan, enc, leaves, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    graph = ref.Graph(ei, etexts, num_nodes, device)
    reference = ref.Reference(model)
    want = reference_steps(reference, cell, weights, feats_np, graph, checked)
    others = flipped_runs(lambda **kw: reference_steps(reference, cell, weights, feats_np,
                                                       graph, checked, **kw), want)
    beside = {}
    correct, checks = compare.held(compare.train_numbers(prog, want, others, beside), cell.limits)
    print(f"worst leaves: {beside}; reference hinges within {ref.KINK_BAND} of the kink, "
          f"by step: {[len(rows) for rows in want['near_kink']]}", file=sys.stderr)
    edges = int(ei.shape[1])
    return SimpleNamespace(
        correct=correct, checks=checks, attempted=steps + len(checked), failed=0,
        setup_s=setup_s, memory_peak_bytes=peak, trace=profiled,
        e2e={"train_edges_per_s": edges * steps / window_s},
        layer=dict(span_ms=span_ms, steps=steps, seconds=window_s, shapes=layout, model=model,
                   neg_mode=mix["neg_mode"]))
