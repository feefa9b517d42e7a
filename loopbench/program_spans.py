"""The program's own spans of the profiled stretch, for the metric readers.

While a profiler records, the program keeps its spans and counters in a
bounded store (``repro_torch.spans``).  A traced run's profiled drains are
the last ``len(ctx.traced)`` root spans of that store: the profiler's
warm-up drain, recorded earlier, is left out.  An untraced run, an empty
store, or a program without the store gives None.
"""
from __future__ import annotations

import importlib


def drains(ctx):
    """The spans of each drain of the profiled stretch (one list of records
    a drain, its root among them), or None."""
    if ctx.trace is None or not ctx.traced:
        return None
    try:
        program = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    recs = program.records()
    roots = [r for r in recs if r.parent is None][-len(ctx.traced):]
    if not roots:
        return None
    by_root = {r.index: [] for r in roots}
    for r in recs:
        if r.root in by_root:
            by_root[r.root].append(r)
    return list(by_root.values())


def ms(records) -> float:
    """The records' summed length (ms)."""
    return sum(r.end_ns - r.start_ns for r in records) / 1e6


def named_ms(ctx, *names):
    """Mean ms a drain in the spans called ``names``; None where no drain
    of the stretch has one."""
    per = drains(ctx)
    if not per:
        return None
    found = [r for d in per for r in d if r.name in names]
    return ms(found) / len(per) if found else None
