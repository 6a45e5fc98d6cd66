"""The 95th percentile (nearest rank) of the local-mapping spans of
``local_map.sweep_ms``, over all the window's sweeps outside the
profiled part (hundreds)."""

from slambench.harness import p95_ms


def read(ctx):
    return p95_ms(ctx.window_spans("local_map.sweep"))
