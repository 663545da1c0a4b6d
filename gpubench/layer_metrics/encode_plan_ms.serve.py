"""Mean host milliseconds of the port's ``encode.sort_plan`` span over the
profiled requests: the SortPlan, ``build_sort_plan``."""

from gpubench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms("encode.sort_plan")
