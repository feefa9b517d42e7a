"""mimo_swa_attention_roofline: the least time of the hybrid period's five
sliding-window layers with sinks (``mimo_swa_attention``) per drain over
their measured device time (%), over the drains of the profiled stretch.
The least time is the larger of their operations over the peak rate and
their bytes over the memory rate (``reference/hybrid_attention.py``); the
device time is every launch of the kernel named
``fa_persistent_swa_sink_kernel`` in the trace."""

KERNEL, MATCH = "mimo_swa_attention", "fa_persistent_swa_sink_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    s = t.kernel_s(MATCH)
    return 100.0 * ctx.least_s(ctx.traced, KERNEL) / s if s > 0 else None
