"""Megabytes a request copies from the host to the card before its
forward (the port's ``to_device_bytes`` counter over the entries of its
``forward.to_device`` span), over the profiled requests."""

from gpubench.layer_metrics._program import per_entry


def read(ctx):
    nbytes = per_entry("to_device_bytes", "forward.to_device")
    return None if nbytes is None else nbytes / 1e6
