"""claim_host_ms: the claim layer's host self time outside its wait on the
card, per drain of the profiled stretch (ms): the program's span
``repro_torch.claim_schedule`` less its child
``repro_torch.claim_schedule.readback``, where the host waits for the
protocol kernel and copies the schedule back."""
from loopbench.program_spans import drains, ms

CLAIM = "repro_torch.claim_schedule"
READBACK = "repro_torch.claim_schedule.readback"


def read(ctx):
    per = drains(ctx)
    if not per:
        return None
    claims = [r for d in per for r in d if r.name == CLAIM]
    if not claims:
        return None
    ids = {r.index for r in claims}
    wait = [r for d in per for r in d if r.name == READBACK and r.parent in ids]
    return (ms(claims) - ms(wait)) / len(per)
