"""mandelbrot_persistent_roofline: the least time of ``mandelbrot_persistent``
per drain over its measured device time (%), over the drains of the
profiled stretch.  The least time is the larger of its operations over the
peak rate and its bytes over the memory rate (``reference/work.py``); the
device time is every launch of the kernel named ``mandelbrot_persistent_kernel`` in the
trace."""

KERNEL, MATCH = "mandelbrot_persistent", "mandelbrot_persistent_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    s = t.kernel_s(MATCH)
    return 100.0 * ctx.least_s(ctx.traced, KERNEL) / s if s > 0 else None
