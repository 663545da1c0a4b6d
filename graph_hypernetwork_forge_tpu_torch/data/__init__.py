"""Host-side graph data of the port: encoding, synthetic and file datasets,
neighbor sampling."""

from graph_hypernetwork_forge_tpu_torch.data.datasets import (
    SyntheticKG,
    fb15k237_like,
    generate_synthetic_kg,
    make_relation_vocabulary,
    wn18rr_zero_shot_like,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import (
    EncodedGraph,
    dedup_texts,
    encode_graph,
)
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.data.sampling import NeighborSampler, SubgraphBatch
from graph_hypernetwork_forge_tpu_torch.data.triples import (
    load_triples_dataset,
    save_triples_dataset,
)

__all__ = [
    "EncodedGraph",
    "NeighborSampler",
    "SubgraphBatch",
    "SyntheticKG",
    "ToyKnowledgeGraph",
    "dedup_texts",
    "encode_graph",
    "fb15k237_like",
    "generate_synthetic_kg",
    "load_triples_dataset",
    "make_relation_vocabulary",
    "save_triples_dataset",
    "wn18rr_zero_shot_like",
]
