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
)
from graph_hypernetwork_forge_tpu_torch.utils.profiling import (
    PhaseTimer,
    count,
    device_trace,
    record,
    reset,
    snapshot,
    span,
    stop,
)
from graph_hypernetwork_forge_tpu_torch.utils.shapes import round_up_to_multiple

__all__ = [
    "HistoryWriter",
    "JsonlWriter",
    "MetricsLogger",
    "PhaseTimer",
    "StdoutWriter",
    "count",
    "device_trace",
    "embedding_params",
    "layer_norm_apply",
    "layer_norm_params",
    "linear_apply",
    "linear_params",
    "linear_params_normal",
    "record",
    "reset",
    "round_up_to_multiple",
    "snapshot",
    "span",
    "stop",
]
