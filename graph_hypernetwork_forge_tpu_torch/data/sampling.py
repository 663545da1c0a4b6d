"""Neighbor sampling → padded minibatch subgraphs.

The counterpart of the JAX package's ``data/sampling.py``: the k-hop
in-neighborhood of a batch of seed nodes, encoded with the port's
:func:`encode_graph` (padded edges carry ``edge_mask = 0``). For each
frontier node, up to ``fanout`` incoming edges are drawn uniformly without
replacement (a degree <= fanout keeps all). Messages flow src → dst, so
in-edges are what reach a seed's embedding.

Draws come from the caller's ``np.random.Generator`` in the JAX sampler's
order, so one seeded generator gives the same subgraph in both packages:
with the native extension one seed per hop (``rng.integers(0, 2**63 - 1)``)
for its C++ hop, else one ``rng.choice`` per frontier node whose degree
exceeds the fanout. The two modes draw different (equally uniform) samples
from each other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from graph_hypernetwork_forge_tpu_torch import native_bridge
from graph_hypernetwork_forge_tpu_torch.data.encoding import EncodedGraph, encode_graph


@dataclasses.dataclass(frozen=True)
class SubgraphBatch:
    """A sampled subgraph with node remapping back to the global graph.

    Attributes:
        graph: the encoded (padded) subgraph; node ids are *local*.
        node_ids: ``[N_sub]`` global node id per local id (sorted).
        seed_local_ids: ``[B]`` local ids of the seed nodes.
        node_features: ``[N_sub, F]`` gathered features.
    """

    graph: EncodedGraph
    node_ids: np.ndarray
    seed_local_ids: np.ndarray
    node_features: np.ndarray


class NeighborSampler:
    """CSR-backed k-hop in-neighbor sampler over a static edge list."""

    def __init__(
        self,
        edge_index: np.ndarray,
        edge_texts: Sequence[str],
        num_nodes: int,
    ) -> None:
        edge_index = np.asarray(edge_index)
        self.num_nodes = int(num_nodes)
        self.edge_texts = list(edge_texts)
        self.src = edge_index[0].astype(np.int64)
        self.dst = edge_index[1].astype(np.int64)
        # CSR over dst: in-edges of node v are edge ids csr_eid[ptr[v]:ptr[v+1]].
        native = native_bridge.get_native()
        if native is not None:
            self._csr_ptr, self._csr_eid = native.build_csr(self.dst, self.num_nodes)
        else:
            self._csr_eid = np.argsort(self.dst, kind="stable")
            counts = np.bincount(self.dst, minlength=self.num_nodes)
            self._csr_ptr = np.concatenate([[0], np.cumsum(counts)])

    def in_edges(self, node: int) -> np.ndarray:
        lo, hi = self._csr_ptr[node], self._csr_ptr[node + 1]
        return self._csr_eid[lo:hi]

    def sample(
        self,
        seed_nodes: Sequence[int],
        fanouts: Sequence[int],
        node_features: np.ndarray,
        *,
        rng: Optional[np.random.Generator] = None,
    ) -> SubgraphBatch:
        """Sample a ``len(fanouts)``-hop in-neighborhood subgraph."""
        rng = rng or np.random.default_rng()
        seeds = np.asarray(seed_nodes, dtype=np.int64)
        frontier = np.unique(seeds)
        chosen_eids: List[np.ndarray] = []
        visited = np.zeros(self.num_nodes, dtype=bool)
        visited[frontier] = True

        native = native_bridge.get_native()
        for fanout in fanouts:
            if native is not None:
                # One C++ pass over the frontier (Floyd's sampling per node),
                # seeded from the caller's generator.
                seed = int(rng.integers(0, 2**63 - 1))
                hop = np.sort(native.sample_hop(
                    self._csr_ptr, self._csr_eid, frontier.astype(np.int64),
                    int(fanout), seed,
                ))
            else:
                hop_eids = []
                for v in frontier:
                    eids = self.in_edges(int(v))
                    if eids.size > fanout:
                        eids = rng.choice(eids, size=fanout, replace=False)
                    hop_eids.append(eids)
                hop = (
                    np.unique(np.concatenate(hop_eids))
                    if hop_eids
                    else np.empty(0, dtype=np.int64)
                )
            chosen_eids.append(hop)
            next_frontier = (
                np.unique(self.src[hop]) if hop.size else np.empty(0, dtype=np.int64)
            )
            frontier = next_frontier[~visited[next_frontier]]
            visited[frontier] = True

        eids = (
            np.unique(np.concatenate(chosen_eids))
            if chosen_eids
            else np.empty(0, dtype=np.int64)
        )
        sub_src_g = self.src[eids]
        sub_dst_g = self.dst[eids]

        node_ids = np.unique(np.concatenate([seeds, sub_src_g, sub_dst_g]))
        # node_ids is sorted, so a local id is a position found by binary search.
        local_src = np.searchsorted(node_ids, sub_src_g)
        local_dst = np.searchsorted(node_ids, sub_dst_g)
        sub_texts = [self.edge_texts[int(e)] for e in eids]

        graph = encode_graph(
            np.stack([local_src, local_dst]) if eids.size else np.zeros((2, 0), np.int64),
            sub_texts,
            num_nodes=len(node_ids),
        )
        return SubgraphBatch(
            graph=graph,
            node_ids=node_ids,
            seed_local_ids=np.searchsorted(node_ids, seeds),
            node_features=np.asarray(node_features)[node_ids],
        )
