"""Weight policies: who gets how much of the loop, per claim.

Port of ``repro.dls.policies``, transliterated unchanged.

The paper's WF scales the FAC2 closed form by a *static* per-PE weight;
its cited adaptive follow-ups make the weight a *measured* quantity.  A
``WeightPolicy`` decouples that choice from the runtimes: the session asks
the policy for the claimer's weight on every claim and feeds execution
timings back through ``record``.  ``weight() -> None`` means "no override"
-- the closed form then falls back to ``LoopSpec.weights`` (static WF) or
1.0 (uniform).

The adaptive family (DESIGN.md Sec. 8) is implemented over the online
telemetry models in ``repro.core.weights``:

  * ``AdaptiveWeights``      -- AWF: timestep-level EMA ``WeightBoard``
  * ``AWFVariantWeights``    -- AWF-B/C/D/E: weighted-average performance
    over ``PerfModel`` snapshot deltas at batch/chunk boundaries,
    optionally timing scheduling overhead (``chunk_calculus.AWF_VARIANTS``)
  * ``AdaptiveFactoring``    -- AF: measured per-PE (mu, sigma) feeding the
    ``AFStats`` closed form via ``af_stats`` instead of ``weight``

All three expose ``node_weight(node, bounds)`` so the hierarchical
runtime's outer (super-chunk) level can claim with telemetry aggregated
to node granularity, and ``trace``/``n_updates`` so sessions can report
the adaptation history (``SessionReport.adaptation``).  See DESIGN.md
Sec. 3 and 8.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

try:  # Protocol is 3.8+; keep a soft fallback for exotic interpreters
    from typing import Protocol, runtime_checkable
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore

    def runtime_checkable(cls):  # type: ignore
        return cls

from repro_torch.core.chunk_calculus import ADAPTIVE, AWF_VARIANTS
from repro_torch.core.weights import (
    AdaptiveFactoringModel,
    AdaptiveWeightModel,
    WeightBoard,
)


@runtime_checkable
class WeightPolicy(Protocol):
    """Per-claim weight source + throughput feedback sink."""

    def weight(self, pe: int) -> Optional[float]:
        """Weight override for PE ``pe``'s next claim; None = use the spec."""
        ...

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        """Feed back observed execution (no-op for static policies).

        ``sched_seconds`` is the claim's scheduling overhead -- only the
        overhead-timing variants (AWF-D/E) consume it.
        """
        ...


class UniformWeights:
    """No override: every PE gets the spec's static weight (or 1.0)."""

    def weight(self, pe: int) -> Optional[float]:
        return None

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        pass


class StaticWeights:
    """Fixed relative weights (the paper's WF), e.g. from core speeds."""

    def __init__(self, weights: Sequence[float]):
        self._w = [float(w) for w in weights]

    def weight(self, pe: int) -> Optional[float]:
        return self._w[pe]

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        pass


class AdaptiveWeights:
    """AWF: live weights from a ``WeightBoard`` EMA of measured throughput."""

    def __init__(self, board: WeightBoard):
        self.board = board

    def weight(self, pe: int) -> Optional[float]:
        return self.board.weight(pe)

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        self.board.record(pe, iters, seconds)


class AWFVariantWeights:
    """AWF-B/C/D/E over a window-backed ``AdaptiveWeightModel``.

    A thin protocol adapter: the adaptation math (weighted-average
    performance over ``PerfModel`` deltas) lives in ``repro.core.weights``
    so the DES drives the identical model.  ``variant`` is one of
    ``chunk_calculus.AWF_VARIANTS``; pass ``window=`` to share telemetry
    across sessions/hosts, or ``perf=`` to share a ready ``PerfModel``.
    """

    def __init__(self, P: int, variant: str = "awf_b", perf=None, window=None):
        if variant not in AWF_VARIANTS:
            raise ValueError(
                f"unknown AWF variant {variant!r}; pick from {tuple(AWF_VARIANTS)}")
        update, overhead = AWF_VARIANTS[variant]
        self.variant = variant
        self.model = AdaptiveWeightModel(
            P, update=update, include_overhead=overhead, perf=perf,
            window=window)

    def weight(self, pe: int) -> Optional[float]:
        return self.model.weight(pe)

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        self.model.record(pe, iters, seconds, sched_seconds)

    def advance(self) -> None:
        """Force an update boundary (timestep-style callers)."""
        self.model.advance()

    def node_weight(self, node: int, bounds) -> Optional[float]:
        return self.model.node_weight(node, bounds)

    @property
    def trace(self):
        return self.model.trace

    @property
    def n_updates(self) -> int:
        return self.model.n_updates


class AdaptiveFactoring:
    """AF over a window-backed ``AdaptiveFactoringModel``.

    AF does not scale a weight: ``weight()`` stays None and the session
    feeds ``af_stats(pe)`` -- the measured (mu, D, T) snapshot -- to the
    runtime, which hands it to ``chunk_calculus.af_chunk_size``.
    """

    def __init__(self, P: int, perf=None, window=None):
        self.model = AdaptiveFactoringModel(P, perf=perf, window=window)

    def weight(self, pe: int) -> Optional[float]:
        return None

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        self.model.record(pe, iters, seconds, sched_seconds)

    def af_stats(self, pe: int):
        return self.model.af_stats(pe)

    def node_weight(self, node: int, bounds) -> Optional[float]:
        return self.model.node_weight(node, bounds)

    @property
    def trace(self):
        return self.model.trace

    @property
    def n_updates(self) -> int:
        return self.model.n_updates


class CallableWeights:
    """Adapter for a plain ``pe -> weight`` callable (legacy ``weight_fn``)."""

    def __init__(self, fn: Callable[[int], float]):
        self.fn = fn

    def weight(self, pe: int) -> Optional[float]:
        return self.fn(pe)

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        pass


def _named_policies(P: int) -> dict:
    """Name -> factory for every string ``loop(weights=...)`` accepts.

    One source of truth: the adaptive names come from
    ``chunk_calculus.ADAPTIVE``/``AWF_VARIANTS``, so facade errors,
    warnings, and docs can never drift from the technique roster.
    """
    named = {
        "uniform": lambda: UniformWeights(),
        "awf": lambda: AdaptiveWeights(WeightBoard(P)),
        "af": lambda: AdaptiveFactoring(P),
    }
    for v in AWF_VARIANTS:
        named[v] = (lambda v=v: AWFVariantWeights(P, variant=v))
    assert set(ADAPTIVE) <= set(named)
    return named


POLICY_NAMES = ("uniform", "awf") + ADAPTIVE


def make_weight_policy(
    weights: Union[None, str, WeightPolicy, WeightBoard, Sequence[float]],
    P: int,
) -> WeightPolicy:
    """Coerce the ``loop(weights=...)`` argument into a policy.

    Accepts None/"uniform", an adaptive technique name ("awf", "af",
    "awf_b".."awf_e" -- fresh telemetry), a WeightBoard, a float sequence
    (static WF weights), or any ready-made WeightPolicy.
    """
    if weights is None:
        return UniformWeights()
    if isinstance(weights, str):
        named = _named_policies(P)
        if weights in named:
            return named[weights]()
        raise ValueError(
            f"unknown weight policy {weights!r}; pick from {POLICY_NAMES}")
    if isinstance(weights, WeightBoard):
        return AdaptiveWeights(weights)
    if isinstance(weights, (UniformWeights, StaticWeights, AdaptiveWeights,
                            AWFVariantWeights, AdaptiveFactoring,
                            CallableWeights)):
        return weights
    if callable(getattr(weights, "weight", None)) and callable(
            getattr(weights, "record", None)):
        return weights  # duck-typed WeightPolicy
    if isinstance(weights, (list, tuple)) or hasattr(weights, "__len__"):
        if len(weights) != P:
            raise ValueError(f"weights must have length P={P}")
        return StaticWeights(weights)
    raise TypeError(f"cannot build a WeightPolicy from {weights!r}")
