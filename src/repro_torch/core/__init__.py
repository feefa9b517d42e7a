"""Core of the paper's contribution: distributed chunk-calculation DLS.

Port of ``repro.core`` (the discrete-event simulator ``sim`` is not ported
yet; ROADMAP.md, "Modules to port", item 7).

Layers:
  chunk_calculus -- Table-2 recurrences + Eq.1-3 closed forms + batched planner
  rma            -- passive-target window (fetch_add) backends
  scheduler      -- One_Sided / Two_Sided / hierarchical runtimes
  weights        -- WF static weights + AWF adaptive reweighting (stragglers)

Consumers should go through the ``repro_torch.dls`` session facade.
"""
from .chunk_calculus import (  # noqa: F401
    ADAPTIVE,
    AWF_VARIANTS,
    TECHNIQUE_INFO,
    TECHNIQUES,
    WEIGHTED,
    AFStats,
    LoopSpec,
    af_chunk_size,
    chunk_series_recurrence,
    chunk_size_closed,
    chunk_sizes_closed,
    max_steps_bound,
    plan,
    plan_torch,
    scheduling_steps,
    technique_table,
    tss_constants,
)
from .rma import (  # noqa: F401
    HierarchicalWindow,
    KVStoreWindow,
    SimWindow,
    ThreadWindow,
    Window,
    make_window,
)
from .scheduler import (  # noqa: F401
    Claim,
    HierarchicalRuntime,
    OneSidedRuntime,
    TwoSidedRuntime,
)
from .weights import (  # noqa: F401
    AdaptiveFactoringModel,
    AdaptiveWeightModel,
    PerfModel,
    WapTracker,
    WeightBoard,
    coefficient_of_variation,
    weights_from_speeds,
)
