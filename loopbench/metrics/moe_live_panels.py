"""moe_live_panels: the program's counter ``live_panels`` on its spans
``repro_torch.moe_experts_up`` and ``repro_torch.moe_experts_down``, the mean
over the routed experts' loops of the profiled stretch's drains: a loop's
most distinct weight panels (expert, column block) among the tiles its
workers start together, at 8 evenly spaced instants of the loop's schedule
at unit cost.  None where no loop carries the counter."""
from loopbench.program_spans import drains

LOOPS = ("repro_torch.moe_experts_up", "repro_torch.moe_experts_down")


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    live = [r.counts["live_panels"] for d in per for r in d
            if r.name in LOOPS and "live_panels" in r.counts]
    return sum(live) / len(live) if live else None
