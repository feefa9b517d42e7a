"""Scenario layer: perturbations every topology inherits from the kernel.

The triplicated pre-refactor event loops could not express runtime
faults without three parallel edits; the unified kernel applies these
uniformly in its shared chunk-execution path, so one_sided, two_sided,
and hierarchical all support them by construction:

* ``PEFailure`` -- the PE dies at a virtual time.  Iterations of its
  in-flight chunk that finished before death stay executed; the
  remainder is **orphaned** and re-claimed by a surviving PE (the
  recovery handoff bypasses the window -- a direct repair transfer, the
  DES analogue of the FT re-claim protocol).  Death models *compute*
  failure only: the passive-target window has no CPU in the loop (the
  paper's point), so a dead coordinator's window keeps serving RMWs.
  The two-sided master is the one PE that may not die (it owns the
  recurrence); ``simulate`` rejects such scenarios.
* ``Straggler`` -- a transient slowdown: the PE runs at ``factor`` of
  its configured speed inside ``[at, until)``.
* ``SpeedDrift`` -- smooth sinusoidal per-PE speed variation (period,
  amplitude, per-PE phase), the time-varying heterogeneity scenario of
  the adaptive-technique studies.

Speed effects are sampled at chunk start (chunk-granular drift -- the
same granularity at which the adaptive techniques can observe it).
Conservation (every iteration executed exactly once) holds under any
survivable scenario (``tests/test_torch_sim.py`` holds the port to the
reference under every kind of perturbation);
``SimConfig.perturbations=None`` compiles to no plan and leaves event
streams byte-identical to the unperturbed simulator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Perturbation:
    """Marker base class for DES scenario perturbations."""


@dataclass(frozen=True)
class PEFailure(Perturbation):
    """PE ``pe`` dies at virtual time ``at`` (its in-flight remainder is
    orphaned and re-claimed by a survivor)."""

    pe: int
    at: float


@dataclass(frozen=True)
class Straggler(Perturbation):
    """PE ``pe`` runs at ``factor`` of its speed inside ``[at, until)``."""

    pe: int
    at: float
    factor: float = 0.25
    until: float = math.inf


@dataclass(frozen=True)
class SpeedDrift(Perturbation):
    """Sinusoidal per-PE speed drift: ``1 + amplitude*sin(2pi(t/period +
    pe/P))`` -- PEs are phase-shifted so the cluster's aggregate speed
    stays roughly constant while individual ranks trade places."""

    amplitude: float = 0.3
    period: float = 60.0


class PerturbationPlan:
    """Compiled scenario state the kernel consults on its hot paths."""

    __slots__ = ("death", "stragglers", "drifts", "P", "_plain_speed")

    def __init__(self, death: np.ndarray, stragglers: Tuple[Straggler, ...],
                 drifts: Tuple[SpeedDrift, ...], P: int):
        self.death = death
        self.stragglers = stragglers
        self.drifts = drifts
        self.P = P
        self._plain_speed = not stragglers and not drifts

    def speed_factor(self, pe: int, t: float) -> float:
        """Multiplicative speed factor for ``pe`` at virtual time ``t``."""
        if self._plain_speed:
            return 1.0
        f = 1.0
        for s in self.stragglers:
            if s.pe == pe and s.at <= t < s.until:
                f *= s.factor
        for d in self.drifts:
            f *= 1.0 + d.amplitude * math.sin(
                2.0 * math.pi * (t / d.period + pe / self.P))
        return f

    def alive(self, pe: int, t: float) -> bool:
        return t < self.death[pe]


def compile_plan(cf) -> Optional[PerturbationPlan]:
    """Validate + compile ``cf.perturbations``; None when there are none."""
    ps = cf.perturbations
    if not ps:
        return None
    P = cf.spec.P
    death = np.full(P, math.inf)
    stragglers, drifts = [], []
    for p in ps:
        if isinstance(p, PEFailure):
            if not 0 <= p.pe < P:
                raise ValueError(f"PEFailure.pe {p.pe} outside [0, {P})")
            if p.at < 0:
                raise ValueError("PEFailure.at must be >= 0")
            death[p.pe] = min(death[p.pe], p.at)
        elif isinstance(p, Straggler):
            if not 0 <= p.pe < P:
                raise ValueError(f"Straggler.pe {p.pe} outside [0, {P})")
            if not 0.0 < p.factor:
                raise ValueError("Straggler.factor must be > 0")
            stragglers.append(p)
        elif isinstance(p, SpeedDrift):
            if not 0.0 <= p.amplitude < 1.0:
                raise ValueError("SpeedDrift.amplitude must be in [0, 1)")
            if p.period <= 0:
                raise ValueError("SpeedDrift.period must be > 0")
            drifts.append(p)
        else:
            raise TypeError(f"unknown perturbation {p!r}")
    if np.isfinite(death).all():
        raise ValueError(
            "scenario kills every PE; at least one must survive to re-claim "
            "orphaned work (conservation would be impossible)")
    if cf.impl == "two_sided" and np.isfinite(death[cf.coordinator]):
        raise ValueError(
            "two_sided master death is not supported: the master owns the "
            "scheduling recurrence (this asymmetry is the paper's point -- "
            "one_sided/hierarchical tolerate any PE death)")
    return PerturbationPlan(death, tuple(stragglers), tuple(drifts), P)
