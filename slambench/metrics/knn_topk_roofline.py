"""The k-NN kernel's share of its roofline, in %: the least time of all
the calls of the profiled part (``peaks.knn_bound_s``, with each call's
live reference count, which the benchmark reads from outside) over the
device time of the kernel's launches there (``knn_topk_*`` kernels in
the trace).  Nothing where the kernel did not run."""

from slambench.peaks import knn_bound_s


def read(ctx):
    calls = ctx.counters.get("knn_calls") or []
    if ctx.trace is None or not calls:
        return None
    kernel_us = sum(b - a for name, a, b in ctx.trace.device_ops
                    if "knn_topk" in name)
    if kernel_us <= 0:
        return None
    bound = sum(knn_bound_s(*c) for c in calls)
    return 100.0 * bound / (kernel_us * 1e-6)
