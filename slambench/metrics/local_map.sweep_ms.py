"""Milliseconds per sweep of local mapping: host-clock spans around
compensator → deskew → ``LocalMapper.process_full`` (which ends in its
pack's readback) outside the profiled part, total over count."""

from slambench.harness import mean_ms


def read(ctx):
    return mean_ms(ctx.window_spans("local_map.sweep"))
