"""Mean host milliseconds of the port's ``encode.tokenize`` span over the
profiled requests: the tokenizer over the unique texts."""

from gpubench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms("encode.tokenize")
