"""The device's idle share of the profiled part of the window: 1 minus
the union of the device operations' intervals (kernels, copies, sets)
over its length, from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.span_us() <= 0:
        return None
    return 1.0 - ctx.trace.busy_us() / ctx.trace.span_us()
