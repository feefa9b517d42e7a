"""tables_ms: host time to make and upload the compute kernels' claim tables,
the program's spans ``repro_torch.worker_lists`` and
``repro_torch.tables_upload``, per drain of the profiled stretch (ms)."""
from loopbench.program_spans import named_ms


def read(ctx):
    return named_ms(ctx, "repro_torch.worker_lists", "repro_torch.tables_upload")
