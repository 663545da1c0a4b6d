"""Mean host milliseconds of the port's ``forward.to_device`` span over the
profiled requests: the copies of the encoded graph and its SortPlan to the
card."""

from gpubench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms("forward.to_device")
