"""mla_tile_costs_ms: host time of the latent attention's tile space, the
program's span ``repro_torch.mla_tile_costs`` (the split-KV tiles and their
costs from the lengths, and their upload, once a drain), per drain of the
profiled stretch (ms)."""
from loopbench.program_spans import named_ms


def read(ctx):
    return named_ms(ctx, "repro_torch.mla_tile_costs")
