"""moe_padded_share: the share of the rows that the routed experts' up loops
compute and that hold no assignment (%), over the drains of the profiled
stretch: 1 - (the program's counter ``routed_rows`` on its spans
``repro_torch.moe_route``) / (its counter ``tile_rows`` on its spans
``repro_torch.moe_experts_up``: each expert's row blocks of 128, the last
one's rows rounded up to wgmma's 64)."""
from loopbench.program_spans import drains


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    routed = sum(r.counts.get("routed_rows", 0) for d in per for r in d
                 if r.name == "repro_torch.moe_route")
    padded = sum(r.counts.get("tile_rows", 0) for d in per for r in d
                 if r.name == "repro_torch.moe_experts_up")
    return 100.0 * (1.0 - routed / padded) if padded else None
