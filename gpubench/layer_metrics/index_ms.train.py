"""Device milliseconds a traced training step spends in PyTorch's row
gathers and their backwards: the index, gather and index-put kernels."""

INDEX_OPS = (r"gather|indexing_backward|index_select|indexSelect|index_add|indexFunc"
             r"|index_elementwise|index_put")


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * ctx.trace.op_seconds(INDEX_OPS) / ctx.trace.units
