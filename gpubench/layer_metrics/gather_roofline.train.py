"""The row gathers' share of HBM's bound in a traced training step: the
least bytes of the step's gathers and their backwards (the port's
``gather_bytes`` counter over the entries of its ``train_step`` span) at
``counts.HBM_BYTES_PER_S``, over the device seconds a step of the kernels
that ``index_ms.train`` reads. The counter may leave out a gather whose
kernels those seconds hold, which only lowers the share; it counts no
gather whose kernels they miss."""

from gpubench import counts
from gpubench.layer_metrics._program import per_entry
from gpubench.run import load_reader


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = per_entry("gather_bytes", "train_step")
    seconds = ctx.trace.op_seconds(load_reader("index_ms.train").INDEX_OPS) / ctx.trace.units
    if nbytes is None or seconds <= 0:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / seconds
