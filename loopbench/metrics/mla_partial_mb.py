"""mla_partial_mb: the bytes that the latent attention's split over KV chunks
writes, the program's counter ``partial_bytes`` (each layer's f32 partials
and log-sum-exps) on its spans ``repro_torch.mla_combine``, per drain of the
profiled stretch (MB, 1e6 bytes): what the split policy costs."""
from loopbench.program_spans import drains


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    spans = [r for d in per for r in d if r.name == "repro_torch.mla_combine"]
    if not spans:
        return None
    return sum(r.counts.get("partial_bytes", 0) for r in spans) / 1e6 / len(per)
