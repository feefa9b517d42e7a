"""repro_torch.replay -- trace capture, calibrated DES replay, and prediction.

The reproduction-and-prediction loop of arXiv:1805.07998 over this
repo's DES (DESIGN.md Sec. 9):

  record    executors + DLSession emit per-chunk timing -> ``Trace`` /
            ``TraceStore`` (versioned JSONL, byte-stable round trip)
  calibrate fit ``SimConfig`` (per-PE speeds, empirical per-iteration
            costs, window/master service times, measurement c.o.v.)
            from a trace; ``percent_error()`` = replay vs native T_loop
  predict   sweep techniques x runtimes through the calibrated DES and
            rank by predicted T_loop
  select    ``dls.loop(N, technique="auto")`` adopts the predicted best
            (decision recorded in ``SessionReport.auto_decision``)
  gantt     ASCII + SVG renderings of any trace

CLI: ``python -m repro_torch.replay {record,calibrate,predict,gantt}``.

Port of ``repro.replay``, transliterated module for module over the port's
DES (``repro_torch.core.sim``, ``repro_torch.sim``): traces, calibrations,
rankings, decisions (but their measured ``sweep_s``) and renderings are
byte-identical to the reference's, and each package reads the other's
trace JSONL.  As in the reference, ``technique="auto"`` with
``runtime="device"`` raises ``ValueError``: the DES has no ``device``
impl.
"""
from .calibrate import Calibration, calibrate  # noqa: F401
from .gantt import gantt_ascii, gantt_svg, save_svg  # noqa: F401
from .predict import (  # noqa: F401
    Prediction,
    predict,
    ranking_table,
    sweep,
)
from .select import choose_technique  # noqa: F401
from .trace import (  # noqa: F401
    TRACE_SCHEMA_VERSION,
    ChunkRecord,
    Trace,
    TraceStore,
    load_trace,
)

__all__ = [
    "Calibration",
    "ChunkRecord",
    "Prediction",
    "TRACE_SCHEMA_VERSION",
    "Trace",
    "TraceStore",
    "calibrate",
    "choose_technique",
    "gantt_ascii",
    "gantt_svg",
    "load_trace",
    "predict",
    "ranking_table",
    "save_svg",
    "sweep",
]
