"""deepseek_mla_decode_roofline: the least time of the latent attention's
required work (``deepseek_mla_decode``) per drain over the measured device
time of the kernels whose names hold ``mla_decode`` (the split-KV kernel and
the combine), over the drains of the profiled stretch (%).  The least time
is the larger of the operations, 2 (576 + 512) a (query row, key) pair a
row sees, over the peak rate and the bytes, the cache pages once a layer and
q and out once, over the memory rate (``reference/mla_decode.py``): the
work any implementation of the layers owes, however it splits or merges."""

KERNEL, MATCH = "deepseek_mla_decode", "mla_decode"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    s = t.kernel_s(MATCH)
    return 100.0 * ctx.least_s(ctx.traced, KERNEL) / s if s > 0 else None
