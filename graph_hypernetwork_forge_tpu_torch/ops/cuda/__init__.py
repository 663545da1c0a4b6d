"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; there is no other fallback.
Each launch counts one in the counter ``kernel.<wrapper>.<form>`` of
``utils/profiling.py`` (``kernel.run_table`` for the run-table kernel),
while recording is on, as the port's other counters.
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
    run_table,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows import (
    gather_rows,
    gather_rows_plain,
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

KERNEL_SOURCES = ("segment_sum", "edge_transform", "edge_transform_bwd", "segment_outer",
                  "gather_rows")

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
    "gather_rows",
    "gather_rows_plain",
    "run_table",
    "segment_outer",
    "segment_outer_plain",
]
