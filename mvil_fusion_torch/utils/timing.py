"""The port's tracer: named host spans, nested per thread, kept in memory.

Counterpart of ``mvil_fusion_tpu/utils/timing.py``, which stands for the
reference's ad-hoc TicToc wall-clock timers (vils_estimator/src/utility/
tic_toc.h and the copies in each package; printStatistics in
visualization.cpp — SURVEY.md §5).  Here one module-level tracer,
``TRACER``, holds every span the port opens:

    TRACER.enable()
    with TRACER.span("local_map.features"):
        ...
    print(TRACER.summary())
    records = TRACER.drain()

Off (the default), ``span`` returns one shared do-nothing context: no
clock read, no allocation, no record.  On, each span keeps one ``Record``
on the host clock of ``time.perf_counter_ns`` (the clock of
``time.perf_counter``); its parent is the span open around it on the same
thread, and a span given no ``rid`` (the request it serves: the sensor
time of the sweep) takes its parent's.  While a ``torch.profiler`` records,
each span is also a ``record_function`` range, so it appears in the
profiler's trace beside the kernels, on the trace's clock.
"""

from __future__ import annotations

import math
import threading
import time
from typing import NamedTuple, Optional

import torch


class Record(NamedTuple):
    """One finished span: name, host-clock start and end (ns), the index
    of the enclosing span's record in the same list (None for a root), the
    request it serves and the thread that ran it."""

    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    rid: Optional[float]
    thread: int


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "rid", "parent", "thread", "rf", "t0",
                 "t1")

    def __init__(self, tracer, name, rid):
        self.tracer, self.name, self.rid = tracer, name, rid

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = parent = stack[-1] if stack else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        self.thread = threading.get_ident()
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        tr._spans.append(self)
        stack.append(self)
        self.t1 = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self.tracer._stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def _records(spans) -> list[Record]:
    """The finished spans as records, a parent as its index among them."""
    done = [s for s in spans if s.t1 is not None]
    index = {s: k for k, s in enumerate(done)}
    return [Record(s.name, s.t0, s.t1, index.get(s.parent), s.rid,
                   s.thread) for s in done]


class Tracer:
    """Spans of the port's layers; see the module docstring."""

    def __init__(self):
        self.on = False
        self._spans: list = []         # in the order they were opened
        self._local = threading.local()

    def _stack(self) -> list:
        """The spans open on the calling thread, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, rid: Optional[float] = None):
        """A context that records the body as span `name` serving request
        `rid` (the enclosing span's where None), when the tracer is on."""
        if not self.on:
            return _OFF
        return _Span(self, name, rid)

    def drain(self) -> list[Record]:
        """The finished spans so far as records, cleared from the tracer.
        Call it with no span open: one still open is dropped."""
        spans, self._spans = self._spans, []
        return _records(spans)

    def summary(self) -> str:
        """One row per span name: count, mean and p95 (nearest rank) of
        its length, and its mean self time (its length less what its
        child spans cover), in ms."""
        recs = _records(list(self._spans))
        child_ns = [0] * len(recs)
        for r in recs:
            if r.parent is not None:
                child_ns[r.parent] += r.t1_ns - r.t0_ns
        by_name: dict = {}
        for k, r in enumerate(recs):
            d = r.t1_ns - r.t0_ns
            by_name.setdefault(r.name, []).append((d, d - child_ns[k]))
        rows = [f"{'span':<28}{'count':>8}{'mean ms':>10}{'p95 ms':>10}"
                f"{'self ms':>10}"]
        for name in sorted(by_name):
            d = sorted(x for x, _ in by_name[name])
            n = len(d)
            p95 = d[math.ceil(0.95 * n) - 1]
            self_ns = sum(s for _, s in by_name[name])
            rows.append(f"{name:<28}{n:>8}{sum(d) / n / 1e6:>10.3f}"
                        f"{p95 / 1e6:>10.3f}{self_ns / n / 1e6:>10.3f}")
        return "\n".join(rows)


TRACER = Tracer()
