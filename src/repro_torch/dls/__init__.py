"""repro_torch.dls -- the public facade for dynamic loop self-scheduling.

Port of ``repro.dls``; the same surface, over the PyTorch/CUDA device plane.

One composable session API over the paper's machinery (see DESIGN.md):

    from repro_torch import dls

    session = dls.loop(1_000_000, technique="awf", P=288,
                       runtime="one_sided", window="auto", weights="awf")
    report = session.execute(work_fn, executor="threads")
    print(report.summary())  # steps, chunk sizes, per-PE busy, c.o.v.

Layers behind the facade (all swappable):
  Runtime      -- one_sided (two atomic fetch-adds, paper Sec. 3),
                  two_sided (master-worker baseline), hierarchical
  Window       -- thread | shm | kvstore | sim | device | auto
                  (repro_torch.core.rma, repro_torch.pt)
  WeightPolicy -- uniform | static WF | the adaptive family (AWF EMA,
                  AWF-B/C/D/E, AF) over online PerfModel telemetry
                  (DESIGN.md Sec. 8)
  Executor     -- serial | threads | processes | sim | device
"""
from repro_torch.core.chunk_calculus import (  # noqa: F401  (re-exported surface)
    ADAPTIVE,
    TECHNIQUES,
    WEIGHTED,
    AFStats,
    LoopSpec,
    technique_table,
)
from repro_torch.core.rma import HierarchicalWindow  # noqa: F401
from repro_torch.core.scheduler import Claim, HierarchicalRuntime  # noqa: F401
from repro_torch.core.weights import PerfModel  # noqa: F401

from .executors import EXECUTORS, execute  # noqa: F401
from .policies import (  # noqa: F401
    POLICY_NAMES,
    AdaptiveFactoring,
    AdaptiveWeights,
    AWFVariantWeights,
    CallableWeights,
    StaticWeights,
    UniformWeights,
    WeightPolicy,
    make_weight_policy,
)
from .report import SessionReport  # noqa: F401
from .runtime import RUNTIMES, Runtime, make_runtime  # noqa: F401
from .session import DLSession, loop  # noqa: F401

__all__ = [
    "ADAPTIVE",
    "AFStats",
    "AWFVariantWeights",
    "AdaptiveFactoring",
    "AdaptiveWeights",
    "CallableWeights",
    "Claim",
    "DLSession",
    "EXECUTORS",
    "HierarchicalRuntime",
    "HierarchicalWindow",
    "LoopSpec",
    "POLICY_NAMES",
    "PerfModel",
    "RUNTIMES",
    "Runtime",
    "SessionReport",
    "StaticWeights",
    "TECHNIQUES",
    "UniformWeights",
    "WEIGHTED",
    "WeightPolicy",
    "execute",
    "loop",
    "make_runtime",
    "make_weight_policy",
    "technique_table",
]
