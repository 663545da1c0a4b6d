"""PyTorch and CUDA port of Graph Hypernetwork Forge.

The counterpart of ``graph_hypernetwork_forge_tpu`` (JAX), which stays the
reference it is held against. Entry points run on the CUDA card unless the
caller asks for the CPU by name (``device="cpu"``); the CUDA kernels under
``csrc/`` are built with nvcc on first launch.
"""

from graph_hypernetwork_forge_tpu_torch.data.encoding import (
    EncodedGraph,
    SortPlan,
    encode_graph,
)
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNN,
    HyperGNNConfig,
    apply_hypergnn,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import TextEncoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import WeightGenerator

__all__ = [
    "EncodedGraph",
    "HyperGNN",
    "HyperGNNConfig",
    "SortPlan",
    "TextEncoder",
    "ToyKnowledgeGraph",
    "WeightGenerator",
    "apply_hypergnn",
    "encode_graph",
    "init_hypergnn",
]
