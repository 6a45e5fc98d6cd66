"""Kernel launches per keyframe solve of the VIL estimator: the launches
inside the program's ``vio.frame`` annotations of the profiled part over
their count (device trace); nothing where the program records no such
span."""


def read(ctx):
    if ctx.trace is None:
        return None
    n, frames = ctx.trace.launches_in("vio.frame")
    return n / frames if frames else None
