"""Milliseconds per ``GlobalMapper.add_submap`` (ScanContext, loop
search and registration, the pose graph's solve when a loop closes):
host-clock spans outside the profiled part, total over count; nothing
where no submap was handed over there."""

from slambench.harness import mean_ms


def read(ctx):
    return mean_ms(ctx.window_spans("global_map.add_submap"))
