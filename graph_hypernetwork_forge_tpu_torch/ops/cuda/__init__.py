"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; there is no other fallback.
"""

from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_contributions_cuda_sorted,
    edge_transform_sorted,
    edge_transform_sorted_combined,
    edge_transform_sorted_combined_plain,
    edge_transform_sorted_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    edge_transform_combined_bwd,
    edge_transform_combined_bwd_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer import (
    segment_outer,
    segment_outer_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    csr_segment_sum_plain,
    dual_sorted_segment_sum,
    dual_sorted_segment_sum_plain,
)

KERNEL_SOURCES = ("segment_sum", "edge_transform", "edge_transform_bwd", "segment_outer")

# The wrappers that count their launches, one per kernel.
_COUNTED = (
    csr_segment_sum,
    edge_transform_sorted_combined,
    edge_transform_combined_bwd,
    edge_transform_sorted,
    segment_outer,
    dual_sorted_segment_sum,
)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


__all__ = [
    "KERNEL_SOURCES",
    "csr_segment_sum",
    "csr_segment_sum_plain",
    "dual_sorted_segment_sum",
    "dual_sorted_segment_sum_plain",
    "edge_contributions_cuda_sorted",
    "edge_transform_combined_bwd",
    "edge_transform_combined_bwd_plain",
    "edge_transform_sorted",
    "edge_transform_sorted_combined",
    "edge_transform_sorted_combined_plain",
    "edge_transform_sorted_plain",
    "reset_launch_counts",
    "segment_outer",
    "segment_outer_plain",
]
