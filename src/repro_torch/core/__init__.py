"""Core of the paper's contribution: distributed chunk-calculation DLS.

Port of ``repro.core``.

Layers:
  chunk_calculus -- Table-2 recurrences + Eq.1-3 closed forms + batched planner
  rma            -- passive-target window (fetch_add) backends
  scheduler      -- One_Sided / Two_Sided / hierarchical runtimes
  weights        -- WF static weights + AWF adaptive reweighting (stragglers)
  sim            -- discrete-event simulator (paper Fig. 4/5 reproduction)

Consumers should go through the ``repro_torch.dls`` session facade.  The
DES event kernel behind ``sim`` lives in ``repro_torch.sim`` (one kernel,
three runtime topologies).
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
from .sim import (  # noqa: F401
    KNL_SPEED,
    XEON_SPEED,
    SimConfig,
    SimResult,
    mandelbrot_costs,
    mandelbrot_iteration_counts,
    paper_cluster,
    psia_costs,
    simulate,
    simulate_many,
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
