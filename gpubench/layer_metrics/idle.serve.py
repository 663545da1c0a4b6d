"""The device's idle share of the unprofiled window (``Trace.idle_share``):
its busy time a request from the profiled stretch, times the window's requests,
over the window's seconds. Where the device never waits it reads about 0,
and a little under 0 where the profiled requests took longer on the device."""


def read(ctx):
    return None if ctx.trace is None else 100.0 * ctx.trace.idle_share(ctx.requests, ctx.seconds)
