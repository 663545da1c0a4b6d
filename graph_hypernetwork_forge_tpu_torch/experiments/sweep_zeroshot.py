"""Zero-shot MRR sweep, the counterpart of the JAX package's
``experiments/sweep_zeroshot.py``: wn18rr-zeroshot (or fb15k237) over a
(num_negatives × seed) grid in one process.

Each run reports filtered MRR / Hits@K on the whole test split, on the
zero-shot-relation subset (relations never seen in training, weights from
their text alone) and per held-out relation, and with ``--eval-every`` the
test metrics of the best-on-valid parameters (``sel_*``); each K gets a
mean±std aggregate line. One JSON line per run and per aggregate, the JAX
script's keys. The same flags, plus ``--device`` (default: the CUDA card;
the JAX script's ``--platform`` is read as a device).

Usage::

    python -m graph_hypernetwork_forge_tpu_torch.experiments.sweep_zeroshot \\
        [--scale 1.0] [--steps 1500] [--negatives 1,8,32] [--seeds 0,1,2] \\
        [--out results.jsonl]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.data.datasets import (
    fb15k237_like,
    wn18rr_zero_shot_like,
)
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.experiments import protocol
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu_torch.training.evaluate import evaluate_link_prediction
from graph_hypernetwork_forge_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
)


def run_one(kg, config, num_negatives, steps, lr, seed, lr_schedule="cosine",
            adv_temp=0.0, weight_decay=0.0, eval_every=0, device=None) -> dict:
    """Train on ``kg``'s train split and score the test split, as the JAX
    script's ``run_one``: K uniform negatives (adversarially weighted at
    ``adv_temp``), Adam (AdamW at ``weight_decay > 0``) under ``lr_schedule``,
    then the evaluation protocol on the full graph's embeddings; with
    ``eval_every``, the valid split is scored every that many steps on the
    train graph's embeddings and the best-on-valid parameters' test
    metrics are the ``sel_*`` keys."""
    dev = resolve_device(device)
    train_ei, train_texts = kg.split_edges("train")
    test_ei, test_texts = kg.split_edges("test")
    feats = torch.as_tensor(kg.node_features, device=dev)
    arrays = protocol.encoded_arrays(train_ei, train_texts, kg.num_nodes, dev)

    params = protocol.to_device(init_hypergnn(config, torch.Generator().manual_seed(seed)), dev)
    optimizer = protocol.make_optimizer(protocol.learning_rate(lr, lr_schedule, steps),
                                        weight_decay)
    state = create_train_state(params, optimizer)
    params, opt_state = state.params, state.opt_state
    step_fn = make_train_step(config, num_negatives=num_negatives,
                              adversarial_temperature=adv_temp)

    # Best-on-valid selection: the valid split scored on the TRAIN graph's
    # embeddings (valid edges never enter message passing), filtered by
    # train + valid; the parameters of the best filtered valid MRR kept.
    valid_ei, _ = kg.split_edges("valid")
    sel_filter = np.concatenate([train_ei, valid_ei], axis=1)
    valid_curve = []
    best = {"step": 0, "valid_mrr": -1.0, "params": None}

    def eval_valid(params, step):
        mv = evaluate_link_prediction(protocol.embeddings(config, params, feats, arrays),
                                      valid_ei[0], valid_ei[1], filter_edges=sel_filter)
        valid_curve.append({"step": step, "valid_mrr": round(mv["mrr"], 4)})
        if mv["mrr"] > best["valid_mrr"]:
            best.update(step=step, valid_mrr=mv["mrr"], params=protocol.host_copy(params))

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    loss = None
    for s in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, feats, *arrays, gen)
        if eval_every and (s + 1) % eval_every == 0:
            eval_valid(params, s + 1)
    final_loss = float(loss)  # one sync at the end
    train_s = time.perf_counter() - t0

    full_arrays = protocol.encoded_arrays(kg.edge_index, kg.edge_texts, kg.num_nodes, dev)
    embs = protocol.embeddings(config, params, feats, full_arrays)
    out = {
        "num_negatives": num_negatives,
        "seed": seed,
        "steps": steps,
        "lr_schedule": lr_schedule,
        "adv_temp": adv_temp,
        "dropout": config.dropout,
        "weight_decay": weight_decay,
        "final_loss": round(final_loss, 4),
        "train_s": round(train_s, 1),
    }
    out.update(protocol.rounded(protocol.evaluate_split(embs, kg, test_ei, test_texts,
                                                        per_relation=True)))

    if eval_every and best["params"] is not None:
        # The best-on-valid checkpoint's test metrics: what a deployment
        # would ship, against the final-step numbers above.
        out["valid_curve"] = valid_curve
        out["best_step"] = best["step"]
        out["best_valid_mrr"] = round(best["valid_mrr"], 4)
        sel_embs = protocol.embeddings(config, protocol.to_device(best["params"], dev),
                                       feats, full_arrays)
        sel = protocol.evaluate_split(sel_embs, kg, test_ei, test_texts)
        out.update({f"sel_{k}": v for k, v in protocol.rounded(sel).items()})
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--dataset", default="wn18rr-zeroshot",
                   choices=["wn18rr-zeroshot", "fb15k237"],
                   help="fb15k237 is transductive (no zero-shot holdout): "
                        "the zero_shot_* columns are then absent")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--negatives", default="1,8,32")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--lr-schedule", default="cosine", choices=["constant", "cosine"])
    p.add_argument("--adv-temp", type=float, default=0.0,
                   help="self-adversarial negative temperature (0 = uniform)")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="AdamW decoupled weight decay (0 = plain Adam)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate the valid split every N steps and report "
                        "sel_* test metrics from the best-on-valid params")
    p.add_argument("--platform", default=None,
                   help="the JAX script's platform flag, read as a device "
                        "(cpu, or gpu for the card)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = protocol.resolve_platform(args.device, args.platform)
    negatives = [int(x) for x in args.negatives.split(",")]
    seeds = [int(x) for x in args.seeds.split(",")]
    lines = []

    def emit(obj):
        s = json.dumps(obj)
        print(s, flush=True)
        lines.append(s)

    for k in negatives:
        rows = []
        for seed in seeds:
            # The dataset varies with the seed too: graph and init both
            # contribute to the spread.
            maker = fb15k237_like if args.dataset == "fb15k237" else wn18rr_zero_shot_like
            kg = maker(seed=seed, scale=args.scale)
            config = HyperGNNConfig(
                text_dim=64, node_feat_dim=kg.node_features.shape[1], hidden_dim=64,
                num_layers=2, rel_sorted=True, dropout=args.dropout,
            )
            row = run_one(kg, config, k, args.steps, args.lr, seed,
                          lr_schedule=args.lr_schedule, adv_temp=args.adv_temp,
                          weight_decay=args.weight_decay, eval_every=args.eval_every,
                          device=device)
            emit(row)
            rows.append(row)
        agg = {"aggregate": True, "dataset": args.dataset, "num_negatives": k,
               "lr_schedule": args.lr_schedule, "steps": args.steps, "scale": args.scale,
               "adv_temp": args.adv_temp, "dropout": args.dropout,
               "weight_decay": args.weight_decay, "n_seeds": len(seeds)}
        for key in ("mrr", "hits@10", "zero_shot_mrr", "zero_shot_hits@10", "sel_mrr",
                    "sel_hits@10", "sel_zero_shot_mrr", "sel_zero_shot_hits@10",
                    "best_step"):
            vals = [r[key] for r in rows if key in r]
            if vals:
                agg[f"{key}_mean"] = round(float(np.mean(vals)), 4)
                agg[f"{key}_std"] = round(float(np.std(vals)), 4)
        emit(agg)

    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
