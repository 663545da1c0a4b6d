"""Models of the port: TextEncoder, WeightGenerator, HyperGNN."""

from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNN,
    HyperGNNConfig,
    apply_hypergnn,
    init_hypergnn,
    score_triple,
)
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
    apply_text_encoder,
    init_text_encoder,
    tokenize_texts,
)
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    WeightGenerator,
    WeightGeneratorConfig,
    apply_weight_generator,
    init_weight_generator,
)

__all__ = [
    "HyperGNN",
    "HyperGNNConfig",
    "TextEncoder",
    "TextEncoderConfig",
    "WeightGenerator",
    "WeightGeneratorConfig",
    "apply_hypergnn",
    "apply_text_encoder",
    "apply_weight_generator",
    "init_hypergnn",
    "init_text_encoder",
    "init_weight_generator",
    "score_triple",
    "tokenize_texts",
]
