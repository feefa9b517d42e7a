"""Self-scheduled data pipeline (port of ``repro.data``)."""
from .pipeline import DLSSampler, EpochState, HostDataIterator, synth_tokens  # noqa: F401
