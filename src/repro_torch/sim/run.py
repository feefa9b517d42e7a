"""Topology dispatch: one ``simulate`` over the unified kernel.

``engine`` selects the execution strategy, not the physics:

* ``"auto"`` (default) -- the vectorized fast path
  (``repro_torch.sim.fast``) when the config qualifies (non-adaptive,
  unperturbed, no trace; see ``fast_qualifies``), else the event
  kernel.  The two are equivalence-pinned (``tests/test_torch_sim.py``)
  so auto-routing never changes results.
* ``"kernel"`` -- force the event kernel (the reference
  implementation; also what every non-qualifying config runs on).
* ``"fast"`` -- force the fast path; raises for configs that do not
  qualify instead of silently approximating them.
"""
from __future__ import annotations

from repro_torch.core.sim import SimConfig, SimResult

from .fast import fast_qualifies, simulate_fast, torch_device
from .hierarchical import HierarchicalEngine
from .one_sided import OneSidedEngine
from .two_sided import TwoSidedEngine

ENGINES = {
    "one_sided": OneSidedEngine,
    "two_sided": TwoSidedEngine,
    "hierarchical": HierarchicalEngine,
}


def simulate(cf: SimConfig, engine: str = "auto",
             backend: str = "numpy", device=None) -> SimResult:
    """Run one configuration; ``engine``/``backend`` select the strategy.

    ``backend``/``device`` are validated on every route (``torch_device``):
    ``backend="torch"`` without a card raises even where the config runs
    on the event kernel, which has no batch round.
    """
    torch_device(backend, device)
    if engine == "auto":
        if fast_qualifies(cf):
            return simulate_fast(cf, backend=backend, device=device)
    elif engine == "fast":
        return simulate_fast(cf, backend=backend, device=device)
    elif engine != "kernel":
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'auto', 'kernel', or 'fast')")
    try:
        cls = ENGINES[cf.impl]
    except KeyError:
        raise ValueError(f"unknown impl {cf.impl!r}") from None
    return cls(cf).run()
