"""What the experiment scripts share: the datasets, the learning rate and
optimizer, the model's embeddings, and the evaluation protocol.

The protocol is the JAX package's experiments': the message-passing graph
for evaluation holds every edge (the standard transductive protocol; the
zero-shot relation texts appear only there), and filtered MRR / Hits@K
are taken with every known edge as the filter, on the whole split, on the
subset whose relations were held out of training, and per held-out
relation.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.data.datasets import (
    SyntheticKG,
    fb15k237_like,
    generate_synthetic_kg,
    wn18rr_zero_shot_like,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.data.triples import load_triples_dataset
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, apply_hypergnn
from graph_hypernetwork_forge_tpu_torch.training.evaluate import evaluate_link_prediction
from graph_hypernetwork_forge_tpu_torch.training.train import (
    Optimizer,
    Schedule,
    adam,
    adamw,
    warmup_cosine_decay_schedule,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_map


def build_dataset(name: str, scale: float, seed: int) -> SyntheticKG:
    """``'tiny'``, ``'fb15k237'``, ``'wn18rr-zeroshot'`` (synthetic), or a
    directory of standard triples files (train/valid/test.txt + optional
    relation_texts.txt)."""
    if os.path.isdir(name):
        return load_triples_dataset(name, seed=seed)
    if name == "fb15k237":
        return fb15k237_like(seed=seed, scale=scale)
    if name == "wn18rr-zeroshot":
        return wn18rr_zero_shot_like(seed=seed, scale=scale)
    if name == "tiny":
        return generate_synthetic_kg(200, 1000, 12, seed=seed, zero_shot_fraction=0.2)
    raise ValueError(f"unknown dataset {name!r}")


def learning_rate(lr: float, schedule: str, steps: int) -> Union[float, Schedule]:
    """``"constant"``: ``lr``; ``"cosine"``: a linear warmup from 0 over 10%
    of the steps, then a cosine decay to 0 at the last."""
    if schedule == "cosine":
        return warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=max(1, steps // 10),
            decay_steps=max(2, steps),
        )
    if schedule != "constant":
        raise ValueError(f"unknown lr schedule {schedule!r}")
    return lr


def make_optimizer(lr: Union[float, Schedule], weight_decay: float = 0.0) -> Optimizer:
    """AdamW with decoupled weight decay when ``weight_decay > 0``, else Adam."""
    return adamw(lr, weight_decay=weight_decay) if weight_decay > 0.0 else adam(lr)


def encoded_arrays(edge_index, edge_texts, num_nodes: int, device) -> tuple:
    """The relation-sorted encoding of the edges, as tensors on ``device``."""
    graph = encode_graph(edge_index, edge_texts, num_nodes, sort_by_relation=True)
    return tuple(torch.as_tensor(a, device=device) for a in graph.arrays)


def to_device(params, device):
    return tree_map(lambda t: t.to(device), params)


def host_copy(params):
    """A copy of the parameters on the host, which later updates leave be."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), params)


def embeddings(config: HyperGNNConfig, params, feats: torch.Tensor, arrays: tuple):
    """The eval-mode embeddings ``[N, H]`` of a graph's arrays."""
    with torch.no_grad():
        return apply_hypergnn(config, params, feats, *arrays)


def evaluate_split(embs, kg: SyntheticKG, split_ei: np.ndarray, split_texts, *,
                   per_relation: bool = False, device=None) -> dict:
    """Filtered MRR and Hits@1/3/10 of a split's pairs over every node, all
    of the graph's edges as the filter (unrounded): on the whole split, on
    its zero-shot subset (``zero_shot_*``) where it has one, and with
    ``per_relation`` each held-out relation's ``n``, ``mrr`` and ``hits@10``
    (``zero_shot_per_relation``, by relation text). ``embs`` is a tensor
    (scored on its device) or an array (scored on ``device``)."""
    def score(mask=None):
        src, dst = (split_ei if mask is None else split_ei[:, mask])
        return evaluate_link_prediction(embs, src, dst, filter_edges=kg.edge_index,
                                        device=device)

    out = score()
    zs_texts = {kg.relation_texts[r] for r in kg.zero_shot_relations}
    zs_mask = np.asarray([t in zs_texts for t in split_texts], dtype=bool)
    if zs_mask.any():
        out.update({f"zero_shot_{k}": v for k, v in score(zs_mask).items()})
        if per_relation:
            texts = np.asarray(split_texts, dtype=object)
            per_rel = {}
            for rid in kg.zero_shot_relations:
                text = kg.relation_texts[rid]
                mask = texts == text
                if mask.any():
                    r = score(mask)
                    per_rel[text] = {"n": int(mask.sum()), "mrr": r["mrr"],
                                     "hits@10": r["hits@10"]}
            out["zero_shot_per_relation"] = per_rel
    return out


def rounded(metrics: dict, digits: int = 4) -> dict:
    """``metrics`` with every float rounded, nested dicts too."""
    return {k: rounded(v, digits) if isinstance(v, dict)
            else round(v, digits) if isinstance(v, float) else v
            for k, v in metrics.items()}


def resolve_platform(device: Optional[str], platform: Optional[str]) -> Optional[str]:
    """``--device``, else the JAX scripts' ``--platform`` read as a device
    (``gpu`` is the card); None is the card."""
    if device is not None or platform is None:
        return device
    return {"gpu": "cuda"}.get(platform, platform)
