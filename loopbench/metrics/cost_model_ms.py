"""cost_model_ms: host time of the entry's default cost model, the program's
span ``repro_torch.varlen_tile_costs``, per drain of the profiled stretch
(ms)."""
from loopbench.program_spans import named_ms


def read(ctx):
    return named_ms(ctx, "repro_torch.varlen_tile_costs")
