"""swa_masked_share: the share of the (row, key) pairs that the cost model
says the sliding-window layers' walk visits and that their mask drops (%),
over the drains of the profiled stretch: 1 - (pairs the SWA layers' valid
rows attend) / (their kv blocks x blk_q x blk_k).  The kv blocks are the
program's counter ``kv_blocks`` on each layer span
``repro_torch.flash_attention_persistent`` whose counter ``window`` is
above 0: the sum of the layer's tile costs (``varlen_tile_costs``), the
blk_k-key blocks the program's cost model assigns the walk, not a count the
kernel keeps.  So this reads the cost model's masked share: it moves with a
change of that model (or of blk_q, blk_k, the window, the lengths), and not
with a kernel that walks less than the model says.  The attended pairs are
the driver's (``reference/hybrid_attention.py``)."""
from loopbench.program_spans import drains

LAYER, KERNEL = "repro_torch.flash_attention_persistent", "mimo_swa_attention"


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    walked = sum(r.counts.get("kv_blocks", 0) for d in per for r in d
                 if r.name == LAYER and r.counts.get("window", 0) > 0)
    if not walked:
        return None
    w = [ctx.work[i]["kernels"][KERNEL] for i in ctx.traced]
    return 100.0 * (1.0 - sum(x["pairs"] for x in w) / (walked * w[0]["block_pairs"]))
