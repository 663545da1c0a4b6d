"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; there is no other fallback.
"""

from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
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
    """Set every kernel wrapper's launch count, and its count per form
    (``launches_by_form``: "f32", "tf32", "bf16", "fast"), to 0, and the
    launches of the run-table kernel that kernels 3 and 6 use where no
    SortPlan hands them its table (``run_table.launches``)."""
    for fn in (*_COUNTED, run_table):
        _common.reset_counts(fn)


def launch_counts() -> dict:
    """A copy of every count :func:`reset_launch_counts` zeroes:
    ``{wrapper: (launches, launches_by_form)}``."""
    return {fn: (fn.launches, dict(fn.launches_by_form)) for fn in (*_COUNTED, run_table)}


def add_launch_counts(after: dict, before: dict, times: int = 1) -> None:
    """Add ``times`` × the launches counted from ``before`` to ``after``
    (two :func:`launch_counts`) to every wrapper's counts: a CUDA graph's
    replay, which runs no wrapper, counts what its capture counted."""
    for fn, (n, forms) in after.items():
        n0, forms0 = before[fn]
        fn.launches += times * (n - n0)
        for form, k in forms.items():
            fn.launches_by_form[form] += times * (k - forms0[form])


__all__ = [
    "KERNEL_SOURCES",
    "add_launch_counts",
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
    "launch_counts",
    "reset_launch_counts",
    "run_table",
    "segment_outer",
    "segment_outer_plain",
]
