"""Host-side helpers of the port: initializers, shapes, metrics, profiling."""

from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    embedding_params,
    layer_norm_apply,
    layer_norm_params,
    linear_apply,
    linear_params,
    linear_params_normal,
)
from graph_hypernetwork_forge_tpu_torch.utils.metrics import (
    HistoryWriter,
    JsonlWriter,
    MetricsLogger,
    StdoutWriter,
    Throughput,
)
from graph_hypernetwork_forge_tpu_torch.utils.profiling import (
    PhaseTimer,
    annotate,
    device_trace,
)
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple

__all__ = [
    "HistoryWriter",
    "JsonlWriter",
    "MetricsLogger",
    "PhaseTimer",
    "StdoutWriter",
    "Throughput",
    "annotate",
    "device_trace",
    "embedding_params",
    "layer_norm_apply",
    "layer_norm_params",
    "linear_apply",
    "linear_params",
    "linear_params_normal",
    "round_up_to_multiple",
]
