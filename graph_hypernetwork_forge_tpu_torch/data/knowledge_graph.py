"""Toy knowledge graph for demos and tests.

The JAX package's ``ToyKnowledgeGraph`` (``graph_hypernetwork_forge_tpu/data/
knowledge_graph.py``): 8 named nodes, 11 directed edges with 7 unique
relation strings, and node features drawn from ``torch.Generator`` seeded
with 42, so both packages hold bitwise the same features.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

_NODE_NAMES = (
    "Alice",
    "Bob",
    "Carol",
    "Dave",
    "Eve",
    "Acme Corp",
    "London",
    "Python",
)

# (src, dst, relation text)
_EDGE_DATA: Tuple[Tuple[int, int, str], ...] = (
    (0, 1, "is spouse of"),
    (1, 0, "is spouse of"),
    (0, 2, "knows"),
    (1, 3, "works with"),
    (2, 3, "knows"),
    (3, 5, "works at"),
    (0, 5, "works at"),
    (5, 6, "located in"),
    (0, 7, "has skill"),
    (3, 7, "has skill"),
    (2, 4, "is parent of"),
)


def _seeded_features(num_nodes: int, feat_dim: int, seed: int = 42) -> np.ndarray:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(num_nodes, feat_dim, generator=gen).numpy()


@dataclasses.dataclass
class ToyKnowledgeGraph:
    """A small in-memory knowledge graph for experimentation.

    Attributes:
        feat_dim: node feature dimension (default 16).
        node_names: human-readable node labels.
        edge_data: list of ``(src, dst, relation_text)`` triples.
        node_features: ``[N, feat_dim]`` float32 numpy array (seed-42 fixed).
        edge_index: ``[2, E]`` int64 numpy array (source row, target row).
        edge_texts: length-E list of relation strings.
    """

    feat_dim: int = 16
    node_names: List[str] = dataclasses.field(
        default_factory=lambda: list(_NODE_NAMES)
    )
    edge_data: List[tuple] = dataclasses.field(
        default_factory=lambda: list(_EDGE_DATA)
    )

    def __post_init__(self) -> None:
        self.node_features: np.ndarray = _seeded_features(
            len(self.node_names), self.feat_dim
        )
        self.edge_index: np.ndarray = np.asarray(
            [[e[0] for e in self.edge_data], [e[1] for e in self.edge_data]],
            dtype=np.int64,
        )
        self.edge_texts: List[str] = [e[2] for e in self.edge_data]

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def relation_types(self) -> List[str]:
        return list(dict.fromkeys(self.edge_texts))

    def __repr__(self) -> str:
        return (
            f"ToyKnowledgeGraph(nodes={self.num_nodes}, "
            f"edges={self.num_edges}, "
            f"relation_types={len(self.relation_types)})"
        )
