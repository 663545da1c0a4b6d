"""The share of their roofline that the port's kernels reach in a traced
training step, shared by the ``<kernel>_roofline`` readers.

The least time of each launch comes from ``counts.train_step_kernels`` at
the cell's shapes; the device time from the profiled stretch. The share is
``None`` (the metric is left out) where the trace holds a port kernel that
the table does not know, or launches other than the table counts."""

from __future__ import annotations

import re
from functools import lru_cache

from gpubench import counts, port

_NAME = re.compile(r"(\w+)\s*[<(]")


@lru_cache(maxsize=1)
def port_kernels() -> frozenset:
    return frozenset(counts.port_kernel_names(port.CSRC))


def kernel_of(op: str):
    """The port kernel an operation of the trace launched, or None."""
    for name in _NAME.findall(op):
        if name in port_kernels():
            return name
    return None


def roofline(ctx, kernel: str):
    if ctx.trace is None:
        return None
    table = counts.train_step_kernels(ctx.model, ctx.shapes, ctx.neg_mode)
    launches, seconds = {}, {}
    for op, a, b in ctx.trace.ops:
        name = kernel_of(op)
        if name is not None:
            launches[name] = launches.get(name, 0) + 1
            seconds[name] = seconds.get(name, 0.0) + (b - a) / 1e6
    steps = ctx.trace.units
    if set(launches) - set(table) or launches.get(kernel) != len(table[kernel]) * steps:
        return None
    return 100.0 * sum(table[kernel]) * steps / 1e3 / seconds[kernel]
