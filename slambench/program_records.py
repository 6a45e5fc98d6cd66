"""Readings of the program's own tracer records that a feed hands over in
``rec.counters``: ``program_records`` (``utils/timing.py``'s records of
the window) and ``profiled_ns`` (the profiled part's start and end on
their clock)."""

from __future__ import annotations


def window_records(counters: dict, name: str) -> list:
    """The records called `name` that started outside the profiled
    part."""
    records = counters.get("program_records") or []
    a, b = counters.get("profiled_ns") or (0, 0)
    return [r for r in records if r.name == name and not a <= r.t0_ns < b]


def window_mean_ms(counters: dict, name: str):
    """Those records' total length over their count, in ms, or None."""
    recs = window_records(counters, name)
    if not recs:
        return None
    return sum(r.t1_ns - r.t0_ns for r in recs) / len(recs) / 1e6
