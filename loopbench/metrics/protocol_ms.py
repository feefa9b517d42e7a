"""protocol_ms: device time of the protocol kernel (``csrc/protocol.cu``,
kernel ``protocol_kernel``) per drain of the profiled stretch (ms)."""

KERNEL = "protocol_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_drains:
        return None
    s = t.kernel_s(KERNEL)
    return 1e3 * s / t.n_drains if s > 0 else None
