"""Mean host milliseconds of the port's ``encode.layout`` span over the
profiled requests: the group-padded layout (the relation sort, the row
scatter and the char-id pad)."""

from gpubench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms("encode.layout")
