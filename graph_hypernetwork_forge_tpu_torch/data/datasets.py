"""Synthetic knowledge-graph datasets with textual relations.

A copy of the JAX package's ``data/datasets.py`` (numpy only), so that the
same seed, scale and arguments give the same arrays, texts and splits in
both packages. It generates deterministic KGs at the sizes of the
benchmark configs in BASELINE.json (FB15k-237-like, WN18RR-like with
relation types held out for zero-shot evaluation) with a scale-free-ish
degree profile, so aggregation load is skewed as in real graphs.
"""

from __future__ import annotations

import dataclasses
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


def make_relation_vocabulary(num_relations: int, seed: int = 0) -> List[str]:
    """Deterministic, distinct, natural-language-ish relation descriptions."""
    rng = np.random.default_rng(seed)
    texts: List[str] = []
    seen = set()
    while len(texts) < num_relations:
        s = rng.choice(_SUBJECTS)
        v = rng.choice(_VERBS)
        q = rng.choice(_QUALIFIERS)
        t = f"{s} {v} {q}".strip() + f" (rel {len(texts)})"
        if t not in seen:
            seen.add(t)
            texts.append(t)
    return texts


@dataclasses.dataclass
class SyntheticKG:
    """A synthetic KG with train/valid/test triple splits and an optional
    zero-shot relation holdout.

    Attributes:
        node_features: ``[N, F]`` float32.
        edge_index: ``[2, E]`` int64 — ALL edges (message-passing graph).
        edge_texts: length-E relation strings.
        relation_texts: the full relation vocabulary.
        splits: dict of name → int index array into the edge list.
        zero_shot_relations: relation ids reserved for the test split only.
    """

    node_features: np.ndarray
    edge_index: np.ndarray
    edge_texts: List[str]
    relation_texts: List[str]
    splits: dict
    zero_shot_relations: Tuple[int, ...] = ()

    @property
    def num_nodes(self) -> int:
        return self.node_features.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    def split_edges(self, name: str) -> Tuple[np.ndarray, List[str]]:
        idx = self.splits[name]
        return (
            self.edge_index[:, idx],
            [self.edge_texts[i] for i in idx],
        )


def generate_synthetic_kg(
    num_nodes: int,
    num_edges: int,
    num_relations: int,
    feat_dim: int = 64,
    *,
    seed: int = 0,
    zero_shot_fraction: float = 0.0,
    valid_fraction: float = 0.05,
    test_fraction: float = 0.1,
) -> SyntheticKG:
    """Generate a deterministic synthetic KG.

    ``zero_shot_fraction`` of the relation types appear *only* in the test
    split (the WN18RR-style inductive setting: weights for them must be
    generated purely from text at eval time).
    """
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    relation_texts = make_relation_vocabulary(num_relations, seed=seed)

    # Scale-free-ish targets: preferential attachment over a growing pool.
    src = rng.integers(0, num_nodes, size=num_edges)
    pool_size = max(16, num_nodes // 50)
    hubs = rng.integers(0, num_nodes, size=pool_size)
    use_hub = rng.random(num_edges) < 0.3
    dst = np.where(use_hub, hubs[rng.integers(0, pool_size, size=num_edges)],
                   rng.integers(0, num_nodes, size=num_edges))
    rel = rng.integers(0, num_relations, size=num_edges)

    n_zs = int(round(zero_shot_fraction * num_relations))
    zs_rels = tuple(int(r) for r in rng.choice(
        num_relations, size=n_zs, replace=False)) if n_zs else ()
    zs_mask = np.isin(rel, np.asarray(zs_rels, dtype=rel.dtype)) if n_zs else (
        np.zeros(num_edges, dtype=bool))

    order = rng.permutation(num_edges)
    non_zs = order[~zs_mask[order]]
    zs = order[zs_mask[order]]

    n_valid = int(round(valid_fraction * num_edges))
    n_test = int(round(test_fraction * num_edges))
    n_test_regular = max(0, n_test - zs.size)
    valid_idx = non_zs[:n_valid]
    test_idx = np.concatenate([zs, non_zs[n_valid : n_valid + n_test_regular]])
    train_idx = non_zs[n_valid + n_test_regular :]

    edge_index = np.stack([src, dst]).astype(np.int64)
    edge_texts = [relation_texts[r] for r in rel]
    return SyntheticKG(
        node_features=feats,
        edge_index=edge_index,
        edge_texts=edge_texts,
        relation_texts=relation_texts,
        splits={
            "train": np.sort(train_idx),
            "valid": np.sort(valid_idx),
            "test": np.sort(test_idx),
        },
        zero_shot_relations=zs_rels,
    )


def fb15k237_like(seed: int = 0, scale: float = 1.0) -> SyntheticKG:
    """FB15k-237-shaped synthetic: ~14.5k entities, 237 relations, ~310k edges."""
    return generate_synthetic_kg(
        num_nodes=int(14_541 * scale),
        num_edges=int(310_116 * scale),
        num_relations=237,
        feat_dim=64,
        seed=seed,
    )


def wn18rr_zero_shot_like(seed: int = 0, scale: float = 1.0) -> SyntheticKG:
    """WN18RR-shaped synthetic with ~27% of relation types held out for
    zero-shot evaluation (weights generated purely from text at test time)."""
    return generate_synthetic_kg(
        num_nodes=int(40_943 * scale),
        num_edges=int(93_003 * scale),
        num_relations=11,
        feat_dim=64,
        seed=seed,
        zero_shot_fraction=0.27,
    )
