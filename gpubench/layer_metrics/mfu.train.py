"""The training step's model FLOPs (``counts.model_flops``) times the steps
of the unprofiled window, over its seconds and the configuration's peak."""

from gpubench import counts


def read(ctx):
    s = ctx.shapes
    flops = counts.model_flops(ctx.model, s["num_nodes"], s["num_edges"], s["num_rel"])
    peak = counts.MODEL_PEAK[ctx.model["compute_dtype"]]
    return 100.0 * flops * ctx.steps / ctx.seconds / peak
