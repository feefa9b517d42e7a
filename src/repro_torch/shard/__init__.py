"""Sharding: logical axes, placements on a ``DeviceMesh``, param rules
(port of ``repro.shard``)."""
from .spec import NO_SHARD, P, ShardCtx, cs, make_ctx, pspec_to_placements  # noqa: F401
from .rules import (  # noqa: F401
    batch_pspecs_for_mesh,
    cache_pspecs,
    distribute,
    fix_divisibility,
    params_pspecs,
    shardings_for,
    to_shardings,
    validate_pspecs,
)
