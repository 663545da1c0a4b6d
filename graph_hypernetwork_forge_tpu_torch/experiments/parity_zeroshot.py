"""Zero-shot quality parity, the counterpart of the JAX package's
``experiments/parity_zeroshot.py``: the port trained with that script's
JAX protocol (its ``run_jax``) on the same synthetic KG, side by side with
a JAX run.

The protocol: wn18rr-zeroshot at ``--scale``, K uniform corrupted tails per
positive and the margin-1.0 hinge, Adam at a constant learning rate,
dropout 0, then the shared filtered evaluator on the full graph's
embeddings (the whole test split and its zero-shot subset). One JSON line
per run under ``"framework": "torch_port"`` and an aggregate line, the JAX
script's keys. ``--against FILE`` reads the JSONL of a run of the JAX
script (``python experiments/parity_zeroshot.py --frameworks jax --out
FILE``) and adds a ``side_by_side`` row, ``port_*`` beside ``jax_*``. The
JAX script's other framework, the original PyTorch reference, is not part
of this repository; the port imports no JAX, so the JAX rows come only
from that file. ``--platform`` (the JAX script's) is read as a device;
``--device`` defaults to the CUDA card.

Usage::

    python experiments/parity_zeroshot.py --frameworks jax --scale 0.1 \\
        --steps 500 --out jax_rows.jsonl
    python -m graph_hypernetwork_forge_tpu_torch.experiments.parity_zeroshot \\
        --scale 0.1 --steps 500 --against jax_rows.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.data.datasets import wn18rr_zero_shot_like
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.experiments import protocol
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)

FRAMEWORK = "torch_port"
SUMMARY_KEYS = ("mrr", "hits@10", "zero_shot_mrr", "zero_shot_hits@10")


def eval_embs(embs, kg, test_ei, test_texts) -> dict:
    """The shared filtered evaluator: the whole test split and its
    zero-shot subset, rounded to 4 places."""
    return protocol.rounded(protocol.evaluate_split(embs, kg, test_ei, test_texts))


def run_port(kg, steps, lr, seed, num_negatives, device=None) -> dict:
    """Train the port on ``kg``'s train split with the JAX run's protocol
    and score it with the same evaluator."""
    dev = resolve_device(device)
    config = HyperGNNConfig(text_dim=64, node_feat_dim=kg.node_features.shape[1],
                            hidden_dim=64, num_layers=2, dropout=0.0, rel_sorted=True)
    train_ei, train_texts = kg.split_edges("train")
    feats = torch.as_tensor(kg.node_features, device=dev)
    arrays = protocol.encoded_arrays(train_ei, train_texts, kg.num_nodes, dev)
    params = protocol.to_device(init_hypergnn(config, torch.Generator().manual_seed(seed)), dev)
    state = create_train_state(params, adam(lr))
    params, opt_state = state.params, state.opt_state
    step_fn = make_train_step(config, num_negatives=num_negatives)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    loss = None
    for _ in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, feats, *arrays, gen)
    final_loss = float(loss)
    train_s = time.perf_counter() - t0

    full_arrays = protocol.encoded_arrays(kg.edge_index, kg.edge_texts, kg.num_nodes, dev)
    embs = protocol.embeddings(config, params, feats, full_arrays)
    test_ei, test_texts = kg.split_edges("test")
    out = {
        "framework": FRAMEWORK,
        "seed": seed,
        "steps": steps,
        "num_negatives": num_negatives,
        "final_loss": round(final_loss, 4),
        "train_s": round(train_s, 1),
    }
    out.update(eval_embs(embs, kg, test_ei, test_texts))
    return out


def aggregate(rows, framework, scale, steps, num_negatives) -> dict:
    agg = {"aggregate": True, "framework": framework, "scale": scale, "steps": steps,
           "num_negatives": num_negatives, "n_seeds": len(rows)}
    for key in SUMMARY_KEYS:
        vals = [r[key] for r in rows if key in r]
        if vals:
            agg[f"{key}_mean"] = round(float(np.mean(vals)), 4)
            agg[f"{key}_std"] = round(float(np.std(vals)), 4)
    return agg


def side_by_side(port_agg: dict, jax_rows_path: str) -> dict:
    """The ``side_by_side`` row: the port's aggregate beside the JAX
    aggregate of a run of the same scale, steps and negatives read from
    ``jax_rows_path``."""
    with open(jax_rows_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    jax_aggs = [r for r in rows if r.get("aggregate") and r.get("framework") == "jax"]
    if not jax_aggs:
        raise ValueError(f"{jax_rows_path}: no JAX aggregate row")
    j = jax_aggs[-1]
    for key in ("scale", "steps", "num_negatives"):
        if j[key] != port_agg[key]:
            raise ValueError(f"{jax_rows_path}: the JAX run's {key} is {j[key]}, "
                             f"this run's {port_agg[key]}")
    out = {"side_by_side": True, "scale": port_agg["scale"], "steps": port_agg["steps"],
           "num_negatives": port_agg["num_negatives"]}
    for key in ("zero_shot_mrr", "mrr", "hits@10"):
        out[f"port_{key}"] = port_agg.get(f"{key}_mean")
        out[f"jax_{key}"] = j.get(f"{key}_mean")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--negatives", type=int, default=1)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--frameworks", default=FRAMEWORK,
                   help=f"only {FRAMEWORK!r} runs here; the JAX rows come from --against")
    p.add_argument("--platform", default=None,
                   help="the JAX script's platform flag, read as a device "
                        "(cpu, or gpu for the card)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--against", default=None,
                   help="JSONL of `python experiments/parity_zeroshot.py "
                        "--frameworks jax --out FILE`: adds the side_by_side row")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    frameworks = args.frameworks.split(",")
    if frameworks != [FRAMEWORK]:
        raise SystemExit(f"parity_zeroshot: only {FRAMEWORK!r} runs in the port, got "
                         f"{args.frameworks!r}; pass a JAX run's rows with --against")
    device = protocol.resolve_platform(args.device, args.platform)
    seeds = [int(x) for x in args.seeds.split(",")]
    lines = []

    def emit(obj):
        s = json.dumps(obj)
        print(s, flush=True)
        lines.append(s)
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(lines) + "\n")

    rows = []
    for seed in seeds:
        kg = wn18rr_zero_shot_like(seed=seed, scale=args.scale)
        row = run_port(kg, args.steps, args.lr, seed, args.negatives, device=device)
        row["scale"] = args.scale
        emit(row)
        rows.append(row)
    agg = aggregate(rows, FRAMEWORK, args.scale, args.steps, args.negatives)
    emit(agg)
    if args.against:
        emit(side_by_side(agg, args.against))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
