"""drain_ms: the drains' time over the drains completed in the window (ms).

Drains run back to back, each timed on the host clock from the call until
the device is synchronized, so this is all of the window's drains and all of
their time.  What the harness does between two drains (keeping or poisoning
an output, synchronized before the next call) is its own and is left out."""


def read(ctx):
    if not ctx.drains_s or ctx.trace is not None:
        return None
    return 1e3 * ctx.window_s / len(ctx.drains_s)
