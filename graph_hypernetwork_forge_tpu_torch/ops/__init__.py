"""Tensor operations of the port: segment reductions, relational message
passing, scoring; the CUDA kernels under ``ops/cuda``."""

from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    relational_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.ops.scoring import (
    score_all_tails,
    score_candidate_sets,
    score_pairs,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import (
    segment_count,
    segment_mean_clamped,
    segment_sum,
)

__all__ = [
    "relational_message_passing",
    "score_all_tails",
    "score_candidate_sets",
    "score_pairs",
    "segment_count",
    "segment_mean_clamped",
    "segment_sum",
]
