"""Milliseconds per keyframe solve of the VIL estimator: the program's
``vio.frame`` spans (``VIOEstimator._solve_and_slide``: table fills and
upload, the frame step, the pack's readback, the slide) outside the
profiled part, total over count (host clock); nothing where the program
records no such span."""

from slambench.program_records import window_mean_ms


def read(ctx):
    return window_mean_ms(ctx.counters, "vio.frame")
