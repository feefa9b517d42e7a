"""mfu: the operations the drains' inputs need over the time the drains took
times the chip's peak rate for them (%), over the drains of a traced run
outside its profiled stretch.  It bounds a gain whatever kernels run."""
from loopbench.reference.work import PEAKS


def read(ctx):
    idx = ctx.untraced()
    t = sum(ctx.drains_s[i] for i in idx)
    if not idx or t <= 0:
        return None
    ops = sum(ctx.work[i]["drain"]["ops"] / PEAKS[ctx.work[i]["drain"]["rate"]]
              for i in idx)
    return 100.0 * ops / t
