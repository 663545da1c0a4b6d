"""Mean host milliseconds of the port's ``encode.dedup`` span over the profiled
requests: the text dedup, one native hash pass over the edges' texts."""

from gpubench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms("encode.dedup")
