"""copy_mb: bytes the program copies between host and card, its counters
``h2d_bytes`` and ``d2h_bytes`` under each drain's root span, per drain of
the profiled stretch (MB, 1e6 bytes): the cost prefix sum up, the schedule
back, the claim tables up."""
from loopbench.program_spans import drains

COUNTERS = ("h2d_bytes", "d2h_bytes")


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    total = sum(r.counts.get(c, 0) for d in per for r in d for c in COUNTERS)
    return total / 1e6 / len(per)
