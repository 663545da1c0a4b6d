"""Mean milliseconds of a request from the end of its encode to its
top-10 tails on the host (``forward_encoded``, scoring, ``topk``, the
copy that waits for the device), over the unprofiled window."""


def read(ctx):
    return ctx.span_ms.get("device")
