"""moe_route_ms: host time from the start of the routed experts' routing to
the return of every layer's loads, the program's span
``repro_torch.moe_route``, per drain of the profiled stretch (ms): the
router products, top-k, sorts and counts enqueued, and the one wait for the
counts, which the claims need."""
from loopbench.program_spans import named_ms


def read(ctx):
    return named_ms(ctx, "repro_torch.moe_route")
