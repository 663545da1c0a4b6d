"""Link-prediction training harness, the counterpart of the JAX package's
``experiments/train_linkpred.py``.

FB15k-237-like and WN18RR-zero-shot-like synthetic KGs (or a directory of
triples files), filtered MRR/Hits@K evaluation, including relations never
seen in training (weights generated from their text alone). The same
flags, protocol and printed lines as the JAX script, plus ``--device``
(default: the CUDA card).

Usage::

    python -m graph_hypernetwork_forge_tpu_torch.experiments.train_linkpred \\
        --dataset fb15k237 --scale 0.05 --steps 200 --eval-every 50
    python -m graph_hypernetwork_forge_tpu_torch.experiments.train_linkpred \\
        --dataset wn18rr-zeroshot --scale 0.1 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.experiments.protocol import (
    build_dataset,
    embeddings,
    encoded_arrays,
    evaluate_split,
    learning_rate,
    to_device,
)
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu_torch.training.checkpoint import save_checkpoint
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_leaves
from graph_hypernetwork_forge_tpu_torch.utils.metrics import MetricsLogger, StdoutWriter


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--dataset",
        default="tiny",
        help="'tiny', 'fb15k237', 'wn18rr-zeroshot' (synthetic), or a "
             "directory of standard triples files (train/valid/test.txt "
             "+ optional relation_texts.txt) for real benchmarks",
    )
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--text-dim", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--lr-schedule", default="constant", choices=["constant", "cosine"],
        help="cosine = linear warmup (10%% of steps) then cosine decay to 0",
    )
    p.add_argument(
        "--num-negatives", type=int, default=1,
        help="corrupted tails per positive (mean hinge over K negatives)",
    )
    p.add_argument(
        "--adv-temp", type=float, default=0.0,
        help="self-adversarial negative temperature (softmax-weighted "
             "hard negatives; requires --num-negatives > 1)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", default="highest", choices=["highest", "default"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The run :func:`main` makes, printing its lines; returns the steps,
    the training loop's seconds without the evaluations, the evaluations'
    seconds, the last loss and the last evaluation's metrics."""
    dev = resolve_device(args.device)
    kg = build_dataset(args.dataset, args.scale, args.seed)
    train_ei, train_texts = kg.split_edges("train")
    test_ei, test_texts = kg.split_edges("test")
    print(
        f"dataset={args.dataset} N={kg.num_nodes} E={kg.num_edges} "
        f"U={len(kg.relation_texts)} train={train_ei.shape[1]} "
        f"test={test_ei.shape[1]} zero_shot_rels={len(kg.zero_shot_relations)}"
    )

    config = HyperGNNConfig(
        text_dim=args.text_dim,
        node_feat_dim=kg.node_features.shape[1],
        hidden_dim=args.hidden_dim,
        num_layers=args.num_layers,
        precision=args.precision,
        rel_sorted=True,  # graphs below are encoded with sort_by_relation
    )
    params = to_device(init_hypergnn(config, torch.Generator().manual_seed(args.seed)), dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model params: {n_params:,}  devices: [{dev}]")

    feats = torch.as_tensor(kg.node_features, device=dev)
    arrays = encoded_arrays(train_ei, train_texts, kg.num_nodes, dev)
    state = create_train_state(params, adam(learning_rate(args.lr, args.lr_schedule,
                                                          args.steps)))
    params, opt_state = state.params, state.opt_state
    step_fn = make_train_step(config, num_negatives=args.num_negatives,
                              adversarial_temperature=args.adv_temp)
    log_every = max(1, args.eval_every // 5)
    logger = MetricsLogger([StdoutWriter(every=log_every)])

    # The evaluation graph holds the test edges too (the transductive
    # protocol); the zero-shot relation texts appear only here.
    full_arrays = encoded_arrays(kg.edge_index, kg.edge_texts, kg.num_nodes, dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    edges_done, eval_s, metrics = 0, 0.0, {}
    for step in range(1, args.steps + 1):
        params, opt_state, loss = step_fn(params, opt_state, feats, *arrays, gen)
        edges_done += train_ei.shape[1]
        if step % log_every == 0 or step == args.steps:
            dt = time.perf_counter() - t0
            logger.log(step, loss=float(loss),
                       edges_per_s=edges_done / dt if dt > 0 else 0.0)
        if step % args.eval_every == 0 or step == args.steps:
            t_eval = time.perf_counter()
            metrics = evaluate_split(embeddings(config, params, feats, full_arrays), kg,
                                     test_ei, test_texts)
            eval_s += time.perf_counter() - t_eval
            print(f"  eval@{step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    final_loss = float(loss)
    train_s = time.perf_counter() - t0 - eval_s

    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, params, opt_state, args.steps, wait=True)
        print(f"checkpoint saved: {path}")
    return dict(steps=args.steps, train_s=train_s, eval_s=eval_s, final_loss=final_loss,
                metrics=metrics)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
