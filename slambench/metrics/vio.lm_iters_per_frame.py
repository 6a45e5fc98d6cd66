"""Levenberg-Marquardt iterations per keyframe solve of the VIL
estimator: the window's increase of the program's counter
``VIOEstimator.lm_iters`` over that of ``VIOEstimator.solves`` (program
counters, bumped on the host; they do not move with the host's pace);
nothing where the program has no such counters."""


def read(ctx):
    iters, solves = (ctx.counters.get(k) for k in ("vio_lm_iters",
                                                    "vio_solves"))
    if iters is None or not solves:
        return None
    return iters / solves
