"""Serving: engine + DLS continuous batching + open-loop scenarios.

Port of ``repro.serve``: ``engine`` (``Engine`` on the card, with the SSD
scan kernel in its prefill), and the numpy-only ``workload``, ``metrics``
and ``scenarios``, transliterated.
"""
from .engine import ContinuousBatcher, Engine, Request  # noqa: F401
from .metrics import (  # noqa: F401
    SLO, SLO_SCHEMA_VERSION, SLOReport, compute_slo)
from .scenarios import (  # noqa: F401
    RESELECT_ROSTER, SCENARIO_SCHEMA_VERSION, ScenarioReport, ServeCostModel,
    run_scenario)
from .workload import (  # noqa: F401
    ARRIVALS, STREAM_SCHEMA_VERSION, RequestStream, ServeRequest, TenantClass,
    generate_stream)
