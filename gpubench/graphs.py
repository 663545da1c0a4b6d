"""The benchmark's graphs, drawn from the seed: frozen copies of the repo's
own generators, so that a change to the program cannot change the traffic.

- ``uniform``: the xl scaling graph (``benchmarks/scaling.py``,
  ``chip_smoke.xl_edges``): uniform heads and tails, uniform relations,
  one fixed text per relation.
- ``synthetic_kg``: ``data/datasets.generate_synthetic_kg``: uniform
  heads, 30% of the tails drawn from a pool of hubs, natural-language-like
  relation texts, and train/valid/test splits of the sizes the
  configuration gives; ``split`` keeps one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_SUBJECTS = (
    "person", "organization", "city", "country", "film", "song", "team",
    "species", "language", "award", "book", "company", "river", "mountain",
)
_VERBS = (
    "is located in", "was founded by", "is a member of", "works for",
    "is married to", "is the capital of", "plays for", "directed",
    "composed", "borders", "speaks", "received", "wrote", "owns",
    "is a subsidiary of", "flows through", "is part of", "influenced",
    "collaborated with", "succeeded",
)
_QUALIFIERS = (
    "", "historically", "officially", "partially", "reportedly",
    "since the founding era", "in the modern period", "according to records",
)

Graph = Tuple[np.ndarray, np.ndarray, List[str]]


def relation_text(rng: np.random.Generator, tag: str) -> str:
    s, v, q = rng.choice(_SUBJECTS), rng.choice(_VERBS), rng.choice(_QUALIFIERS)
    return f"{s} {v} {q}".strip() + f" ({tag})"


def relation_vocabulary(num_relations: int, seed: int) -> List[str]:
    rng = np.random.default_rng(seed)
    texts: List[str] = []
    seen = set()
    while len(texts) < num_relations:
        t = relation_text(rng, f"rel {len(texts)}")
        if t not in seen:
            seen.add(t)
            texts.append(t)
    return texts


def uniform(seed: int, num_nodes: int, num_edges: int, num_relations: int,
            feat_dim: int) -> Graph:
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    ei = np.stack([rng.integers(0, num_nodes, size=num_edges),
                   rng.integers(0, num_nodes, size=num_edges)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(num_relations)]
    return feats, ei, [texts[i] for i in rng.integers(0, num_relations, size=num_edges)]


def synthetic_kg(seed: int, num_nodes: int, num_edges: int, num_relations: int,
                 feat_dim: int, split: str = "train", valid_edges: int | None = None,
                 test_edges: int | None = None) -> Graph:
    """``valid_edges`` and ``test_edges`` size those splits (by default 5%
    and 10% of the triples, as the original generator draws them); the
    train split holds the rest."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    texts = relation_vocabulary(num_relations, seed)
    src = rng.integers(0, num_nodes, size=num_edges)
    pool = max(16, num_nodes // 50)
    hubs = rng.integers(0, num_nodes, size=pool)
    use_hub = rng.random(num_edges) < 0.3
    dst = np.where(use_hub, hubs[rng.integers(0, pool, size=num_edges)],
                   rng.integers(0, num_nodes, size=num_edges))
    rel = rng.integers(0, num_relations, size=num_edges)
    order = rng.permutation(num_edges)
    n_valid = int(round(0.05 * num_edges)) if valid_edges is None else valid_edges
    n_test = int(round(0.1 * num_edges)) if test_edges is None else test_edges
    idx = {"valid": order[:n_valid], "test": order[n_valid:n_valid + n_test],
           "train": order[n_valid + n_test:]}[split]
    idx = np.sort(idx)
    ei = np.stack([src[idx], dst[idx]]).astype(np.int64)
    return feats, ei, [texts[r] for r in rel[idx]]


def draw(graph: dict, seed: int, feat_dim: int) -> Graph:
    """The configuration's graph ``(features, edge_index, edge_texts)``."""
    kind = graph["generator"]
    sizes = dict(num_nodes=graph["num_nodes"], num_edges=graph["num_edges"],
                 num_relations=graph["num_relations"], feat_dim=feat_dim)
    if kind == "uniform":
        return uniform(seed, **sizes)
    if kind == "synthetic_kg":
        return synthetic_kg(seed, split=graph.get("split", "train"),
                            valid_edges=graph.get("valid_edges"),
                            test_edges=graph.get("test_edges"), **sizes)
    raise ValueError(f"unknown graph generator {kind!r}")
