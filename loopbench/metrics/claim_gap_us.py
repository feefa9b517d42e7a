"""claim_gap_us: mean host time from a thread's return from the loop body to
its next call into it (us): the facade's claim and bookkeeping, from the
driver's own spans."""


def read(ctx):
    g = ctx.spans.get("claim_gaps_s") or []
    return 1e6 * sum(g) / len(g) if g else None
