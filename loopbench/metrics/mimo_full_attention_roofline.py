"""mimo_full_attention_roofline: the least time of the hybrid period's full
layer (``mimo_full_attention``) per drain over its measured device time (%),
over the drains of the profiled stretch.  The least time is the larger of
its operations over the peak rate and its bytes over the memory rate
(``reference/hybrid_attention.py``); the device time is every launch of the
kernel named ``fa_persistent_full_kernel`` in the trace."""

KERNEL, MATCH = "mimo_full_attention", "fa_persistent_full_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    s = t.kernel_s(MATCH)
    return 100.0 * ctx.least_s(ctx.traced, KERNEL) / s if s > 0 else None
