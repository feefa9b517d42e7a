"""Unified event-kernel DES: one kernel, three runtime topologies.

Port of ``repro.sim``, transliterated module for module: one event-driven
kernel (``EventQueue`` + ``Resource`` + a shared PE process model) over
which the one-sided, two-sided, and hierarchical runtimes are
declarative topology descriptions -- see DESIGN.md Sec. 10.

Layers:

  kernel        -- EventQueue, Resource (serialization points), Engine
  one_sided / two_sided / hierarchical -- the topology engines
  fast          -- vectorized fast path for non-adaptive, unperturbed
                   runs on any topology (DESIGN.md Sec. 12); its one-sided
                   batch round can run on the card (``backend="torch"``)
  fast_batch    -- ``simulate_fast_many``: batched roster sweeps over a
                   shared ``SweepCache`` (DESIGN.md Sec. 15)
  telemetry     -- shared adaptive-technique noise/lag front end
  perturb       -- PE failure/churn, stragglers, speed drift scenarios
  batch         -- ``simulate_many`` process-pool prediction sweeps

``repro_torch.core.sim`` remains the stable public API (``SimConfig`` /
``SimResult`` / ``simulate``) and delegates here.  Nothing in this
package imports torch at module level: spawned sweep workers import it
without touching the card.
"""
from .batch import estimate_batch_iters, resolve_workers, simulate_many  # noqa: F401,E501
from .fast import fast_qualifies, simulate_fast  # noqa: F401
from .fast_batch import SweepCache, simulate_fast_many  # noqa: F401
from .kernel import Engine, EventQueue, Resource  # noqa: F401
from .perturb import (  # noqa: F401
    PEFailure,
    Perturbation,
    SpeedDrift,
    Straggler,
)
from .run import ENGINES, simulate  # noqa: F401
from .telemetry import AdaptiveTelemetry, telemetry_for  # noqa: F401
