"""drains_per_s: the drains completed in the window over their time (1/s).

Exactly ``drain_ms`` inverted (1000 / ``drain_ms``), of the same drains.  It
exists only to carry a tighter bound than ``drain_ms`` can, since the bound
of an end-to-end metric is one for every cell: it is reported where the
drain is steady (a device-bound loop), so that a loss there does not hide
under the bound that host-bound cells need."""


def read(ctx):
    if not ctx.drains_s or ctx.trace is not None or ctx.window_s <= 0:
        return None
    return len(ctx.drains_s) / ctx.window_s
