"""drain_p95_ms: the 95th percentile of single drains on the host clock (ms),
over the drains of a traced run outside its profiled stretch (numpy's
linear percentile).  A single drain is shorter than the host clock's error
allows an end-to-end metric to read, so this stands as a per-layer metric
beside ``drain_ms``."""
import numpy as np


def read(ctx):
    d = [ctx.drains_s[i] for i in ctx.untraced()]
    return float(np.percentile(d, 95)) * 1e3 if len(d) >= 20 else None
