"""mimo_moe_experts_roofline: the least time of the routed experts' two
loops (``mimo_moe_experts``) per drain over their measured device time (%),
over the drains of the profiled stretch.  The least time is the larger of
their operations (6 d ff an assignment held here: gate and up, then down)
over the peak rate and their bytes (the held experts' weights once a layer,
the assignments' rows of x, h written and read, the expert rows written)
over the memory rate (``reference/moe_experts.py``); the device time is every
launch of the kernels whose names hold ``moe_experts_`` (the up and the down
kernel) in the trace."""

KERNEL, MATCH = "mimo_moe_experts", "moe_experts_"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    s = t.kernel_s(MATCH)
    return 100.0 * ctx.least_s(ctx.traced, KERNEL) / s if s > 0 else None
