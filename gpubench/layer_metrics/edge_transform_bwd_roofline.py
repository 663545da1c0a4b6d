"""Kernel `edge_transform_bwd_kernel`'s share of its roofline over a traced training
step's launches (`_kernels.roofline`)."""

from gpubench.layer_metrics._kernels import roofline


def read(ctx):
    return roofline(ctx, "edge_transform_bwd_kernel")
