"""Mean host milliseconds of a request's encode (``HyperGNN.preprocess``)
over the requests of the unprofiled window."""


def read(ctx):
    return ctx.span_ms.get("preprocess")
