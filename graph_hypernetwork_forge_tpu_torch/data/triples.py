"""Dataset ingestion: standard triples files → the port's arrays.

The counterpart of the JAX package's ``data/triples.py``. It loads the
train/valid/test triple format that KG benchmarks ship (FB15k-237, WN18RR,
Wikidata5M, CoDEx, ...)::

    <head>\t<relation>\t<tail>

one line per triple, plus an optional ``relation_texts.txt`` of
``<relation>\t<description>`` lines (without it the relation token is its
own text). The result is the :class:`~graph_hypernetwork_forge_tpu_torch.
data.datasets.SyntheticKG` container the synthetic generators emit, so
encoding, training and the filtered evaluator run on it unchanged. Real KGs
carry no node features: seeded Gaussian features are drawn, as the
synthetic datasets draw theirs. Nothing is downloaded;
``tests/fixtures/tiny_kg`` is a committed miniature.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from graph_hypernetwork_forge_tpu_torch.data.datasets import SyntheticKG

_SPLIT_FILES = ("train", "valid", "test")


def read_triples(path: str) -> List[Tuple[str, str, str]]:
    """Read one ``head\\trelation\\ttail`` file (blank lines skipped)."""
    triples = []
    with open(path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) != 3:
                raise ValueError(
                    f"{path}:{line_no}: expected 3 tab-separated fields, "
                    f"got {len(parts)}: {line!r}"
                )
            triples.append((parts[0], parts[1], parts[2]))
    return triples


def read_relation_texts(path: str) -> Dict[str, str]:
    """Read ``relation\\tdescription`` lines into a map."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split("\t", 1)
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{line_no}: expected 'relation\\ttext': {line!r}"
                )
            out[parts[0]] = parts[1]
    return out


def load_triples_dataset(
    path: str,
    *,
    feat_dim: int = 64,
    seed: int = 0,
    relation_texts_file: Optional[str] = None,
) -> SyntheticKG:
    """Load a triples directory into a :class:`SyntheticKG`.

    ``path`` must contain ``train.txt``, ``valid.txt``, ``test.txt``
    (``valid.txt`` may be absent → empty valid split). Entity and relation
    ids are assigned by first occurrence in file order (train → valid →
    test), so ids are deterministic for a given dataset.

    Zero-shot relations are DERIVED, not configured: any relation that
    appears in valid/test but never in train is recorded in
    ``zero_shot_relations`` — on WN18RR-style inductive splits this
    reproduces the benchmark's held-out relation semantics, and on
    transductive splits it is simply empty.
    """
    split_triples: Dict[str, List[Tuple[str, str, str]]] = {}
    for name in _SPLIT_FILES:
        fp = os.path.join(path, f"{name}.txt")
        if os.path.exists(fp):
            split_triples[name] = read_triples(fp)
        elif name == "valid":
            split_triples[name] = []
        else:
            raise FileNotFoundError(f"required triples file missing: {fp}")

    rel_text_map: Dict[str, str] = {}
    rt_file = relation_texts_file or os.path.join(path, "relation_texts.txt")
    if os.path.exists(rt_file):
        rel_text_map = read_relation_texts(rt_file)

    ent_ids: Dict[str, int] = {}
    rel_ids: Dict[str, int] = {}

    def ent(tok: str) -> int:
        if tok not in ent_ids:
            ent_ids[tok] = len(ent_ids)
        return ent_ids[tok]

    def rel(tok: str) -> int:
        if tok not in rel_ids:
            rel_ids[tok] = len(rel_ids)
        return rel_ids[tok]

    src_all: List[int] = []
    dst_all: List[int] = []
    rel_all: List[int] = []
    splits: Dict[str, np.ndarray] = {}
    offset = 0
    train_rels: set = set()
    for name in _SPLIT_FILES:
        rows = split_triples[name]
        for h, r, t in rows:
            src_all.append(ent(h))
            rel_all.append(rel(r))
            dst_all.append(ent(t))
            if name == "train":
                train_rels.add(rel_ids[r])
        splits[name] = np.arange(offset, offset + len(rows), dtype=np.int64)
        offset += len(rows)

    n = len(ent_ids)
    num_edges = len(src_all)
    if num_edges == 0:
        raise ValueError(f"no triples found under {path}")

    relation_texts = [
        rel_text_map.get(tok, tok) for tok in rel_ids  # insertion order
    ]
    edge_index = np.stack(
        [np.asarray(src_all, dtype=np.int64),
         np.asarray(dst_all, dtype=np.int64)]
    )
    edge_texts = [relation_texts[r] for r in rel_all]

    zs_rels = tuple(sorted(set(rel_all) - train_rels))

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, feat_dim)).astype(np.float32)

    return SyntheticKG(
        node_features=feats,
        edge_index=edge_index,
        edge_texts=edge_texts,
        relation_texts=relation_texts,
        splits=splits,
        zero_shot_relations=zs_rels,
    )


def save_triples_dataset(
    path: str,
    kg: SyntheticKG,
    *,
    entity_names: Optional[Sequence[str]] = None,
) -> None:
    """Write a :class:`SyntheticKG` back out as standard triples files
    (round-trip utility; also handy for exporting synthetic graphs in the
    format other KG toolkits consume)."""
    os.makedirs(path, exist_ok=True)
    names = (
        list(entity_names) if entity_names is not None
        else [f"e{i}" for i in range(kg.num_nodes)]
    )
    if len(set(kg.relation_texts)) != len(kg.relation_texts):
        # Per-edge relations are only recoverable via their text
        # (SyntheticKG carries no per-edge relation ids); two relations
        # sharing a description would silently merge on round-trip.
        raise ValueError(
            "save_triples_dataset requires unique relation_texts: "
            "duplicate descriptions would merge distinct relations"
        )
    text_to_tok = {t: f"r{i}" for i, t in enumerate(kg.relation_texts)}
    with open(os.path.join(path, "relation_texts.txt"), "w",
              encoding="utf-8") as f:
        for t, tok in text_to_tok.items():
            f.write(f"{tok}\t{t}\n")
    for name in _SPLIT_FILES:
        idx = kg.splits.get(name, np.empty(0, dtype=np.int64))
        with open(os.path.join(path, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            for i in idx:
                s, d = int(kg.edge_index[0, i]), int(kg.edge_index[1, i])
                f.write(
                    f"{names[s]}\t{text_to_tok[kg.edge_texts[i]]}\t{names[d]}\n"
                )
