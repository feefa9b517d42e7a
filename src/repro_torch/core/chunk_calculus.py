"""Chunk calculus for dynamic loop self-scheduling (DLS).

Port of ``repro.core.chunk_calculus``: the numpy code is transliterated
unchanged (schedules are byte-identical to the reference's); the
on-device planner ``plan_jax`` becomes ``plan_torch``.

This module is the mathematical heart of the paper (Table 2 + Eq. 1-3 of
Eleliemy & Ciorba 2018): for each self-scheduling technique it provides

  * the **recurrence form** ``chunk_series_recurrence`` -- the classical
    master-side computation ``K_i = f(K_{i-1}, R_i)`` (Table 2), which is
    inherently sequential, and
  * the **closed form** ``chunk_size_closed`` -- ``K'_i`` as a pure function
    of the scheduling-step index ``i`` alone (Eq. 1-3), which is what makes
    the *distributed* chunk calculation possible: any PE that atomically
    fetches an ``i`` can compute its chunk with no other shared state,
  * a **batched planner** ``plan`` -- the accelerator corollary: because
    ``K'_i`` is index-only, chunk *starts* are ``cumsum(K'_0..K'_{i-1})``,
    i.e. an associative scan.  A whole schedule can be materialized in one
    vectorized pass (numpy) or on-device (``plan_torch``).  The master-worker
    recurrence cannot do this.  This is recorded in DESIGN.md as the key
    beyond-paper optimization the closed forms unlock.

Techniques: STATIC, SS, GSS, TSS, FAC2, WF (paper) + TFSS, AWF (beyond
paper; Chronopoulos 2005 / Banicescu 2003 -- the paper cites both families
as derived work) + the *adaptive* family of the verification study
(Mohammed et al., arXiv:1804.11115): AF (Banicescu & Liu 2000) and the
AWF batch/chunk variants AWF-B/C/D/E (Carino & Banicescu 2008).  The
adaptive forms measure PE performance online -- the telemetry layer lives
in ``core/weights.py`` (``PerfModel``), see DESIGN.md Sec. 8; this module
holds only the per-claim chunk math.

Everything here is host-plane math over integers in numpy; only
``plan_torch`` touches a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np

#: Single source of truth for the technique roster.  Every name dispatched
#: anywhere in the repo (runtimes, DES, planner, facade, docs tables) comes
#: from this registry; README.md / DESIGN.md tables are generated from it
#: (``technique_table()``) and CI fails if they drift (tests/test_docs.py).
TECHNIQUE_INFO = {
    "static": dict(label="Static", summary="one ceil(N/P) block per PE",
                   source="paper Table 2"),
    "ss": dict(label="SS", summary="self-scheduling, min_chunk per claim",
               source="paper Table 2"),
    "gss": dict(label="GSS", summary="guided: ceil of 1/P of the remainder",
                source="paper Eq. 1"),
    "tss": dict(label="TSS", summary="trapezoid: linear ramp K_0 -> 1",
                source="paper Eq. 2"),
    "fac2": dict(label="FAC2", summary="factoring: batches halving the "
                 "remainder, split P ways", source="paper Eq. 3"),
    "wf": dict(label="WF", summary="FAC2 scaled by static PE weights",
               source="paper Table 2"),
    "tfss": dict(label="TFSS", summary="trapezoid factoring: batches of P "
                 "mean-TSS chunks", source="Chronopoulos 2005"),
    "awf": dict(label="AWF", summary="WF with timestep-measured weights "
                "(EMA WeightBoard)", source="Banicescu 2003"),
    "af": dict(label="AF", summary="adaptive factoring from measured "
               "per-PE (mu, sigma)", source="Banicescu & Liu 2000"),
    "awf_b": dict(label="AWF-B", summary="AWF reweighted every batch",
                  source="Carino & Banicescu 2008"),
    "awf_c": dict(label="AWF-C", summary="AWF reweighted every chunk",
                  source="Carino & Banicescu 2008"),
    "awf_d": dict(label="AWF-D", summary="AWF-B timing compute + scheduling "
                  "overhead", source="Carino & Banicescu 2008"),
    "awf_e": dict(label="AWF-E", summary="AWF-C timing compute + scheduling "
                  "overhead", source="Carino & Banicescu 2008"),
}

TECHNIQUES = tuple(TECHNIQUE_INFO)

# Techniques whose chunk size depends on the claiming PE's weight
# (the WF closed form scaled by a static or live weight).
WEIGHTED = ("wf", "awf", "awf_b", "awf_c", "awf_d", "awf_e")

# Techniques that *measure* PE performance online instead of trusting a
# priori weights (arXiv:1804.11115's adaptive rows).  ``awf`` is excluded
# on purpose: in this repo it is the timestep-level variant whose weights
# are supplied by an external policy (``weights="awf"``), while the
# techniques below default to an online ``PerfModel``-driven policy.
ADAPTIVE = ("af", "awf_b", "awf_c", "awf_d", "awf_e")

#: (update boundary, include scheduling overhead) per AWF variant --
#: shared by the weight policies (repro.dls.policies) and the DES.
AWF_VARIANTS = {
    "awf_b": ("batch", False),
    "awf_c": ("chunk", False),
    "awf_d": ("batch", True),
    "awf_e": ("chunk", True),
}

# Techniques that consume a WeightPolicy at claim time (weight-scaled or
# AF-stat-fed) -- the facade's "your weights will actually act" set.
POLICY_DRIVEN = tuple(dict.fromkeys(WEIGHTED + ADAPTIVE))

# The transformed-FAC2 family: one batch-halving closed form, optionally
# weight-scaled.  AF bootstraps through this form until telemetry exists.
FAC_FAMILY = ("fac2", "wf", "awf", "awf_b", "awf_c", "awf_d", "awf_e", "af")


def technique_table() -> str:
    """The markdown technique table embedded in README.md / DESIGN.md.

    Generated (``scripts/gen_technique_table.py``) and drift-checked
    (``tests/test_docs.py``) so the docs can never disagree with the code.
    """
    rows = ["| name | label | chunk rule | weighted | adaptive | source |",
            "|------|-------|------------|----------|----------|--------|"]
    for name, info in TECHNIQUE_INFO.items():
        rows.append(
            f"| `{name}` | {info['label']} | {info['summary']} "
            f"| {'yes' if name in WEIGHTED else 'no'} "
            f"| {'yes' if name in ADAPTIVE else 'no'} "
            f"| {info['source']} |")
    return "\n".join(rows)


class AFStats(NamedTuple):
    """Adaptive Factoring's per-claim telemetry snapshot (seconds/iteration).

    ``mu``: the claiming PE's measured mean iteration time; ``D``/``T`` the
    cluster aggregates ``sum_j sigma_j^2/mu_j`` and ``1/sum_j (1/mu_j)``
    (Banicescu & Liu 2000).  Produced by ``weights.AdaptiveFactoringModel``.
    """

    mu: float
    D: float
    T: float


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """A scheduling problem: N independent iterations over P processing elements."""

    technique: str
    N: int
    P: int
    # Relative PE weights (sum == P), only used by WF/AWF.  Defaults to uniform.
    weights: Optional[tuple] = None
    # SS/FAC2 style minimum chunk; also TSS's K_{S-1}.
    min_chunk: int = 1
    # Optional chunk-size cap (beyond-paper FT refinement): bounds the work
    # lost when a PE dies mid-chunk.  Still a pure function of i, so the
    # distributed protocol is unchanged.
    max_chunk: Optional[int] = None

    def __post_init__(self):
        if self.technique not in TECHNIQUES:
            raise ValueError(f"unknown technique {self.technique!r}; pick from {TECHNIQUES}")
        if self.N <= 0 or self.P <= 0:
            raise ValueError("N and P must be positive")
        if self.weights is not None and len(self.weights) != self.P:
            raise ValueError("weights must have length P")

    def weight(self, pe: int) -> float:
        if self.weights is None:
            return 1.0
        return float(self.weights[pe])


# ---------------------------------------------------------------------------
# TSS constants (paper Table 2): K_0 = ceil(N/2P), K_{S-1} = 1,
# S = ceil(2N / (K_0 + K_{S-1})), C = floor((K_0 - K_{S-1}) / (S - 1)).
# ---------------------------------------------------------------------------

def tss_constants(N: int, P: int, min_chunk: int = 1):
    K0 = max(int(math.ceil(N / (2.0 * P))), min_chunk)
    Klast = min_chunk
    S = max(int(math.ceil(2.0 * N / (K0 + Klast))), 1)
    C = 0 if S <= 1 else (K0 - Klast) // (S - 1)
    return K0, Klast, S, C


# ---------------------------------------------------------------------------
# Closed forms (paper Eq. 1-3).  Pure functions of the step index i.
# ---------------------------------------------------------------------------

def chunk_size_closed(spec: LoopSpec, i: int, pe: int = 0,
                      weight: Optional[float] = None,
                      af_stats: Optional[AFStats] = None,
                      remaining: Optional[int] = None) -> int:
    """K'_i -- chunk size at scheduling step ``i`` (closed form, scalar).

    This is exactly what a PE computes in Step 2 of the paper's protocol,
    using only its private copy of ``i`` (and, for WF/AWF, its own weight).
    ``weight`` overrides the spec's static weight for the WF family -- this
    is how the AWF variants' live, measured weights enter the closed form;
    it is ignored by unweighted techniques.  ``af_stats``/``remaining``
    feed Adaptive Factoring; with either absent, AF bootstraps through the
    FAC2 form (no telemetry yet, the standard AF cold start).
    """
    k = _chunk_size_closed(spec, i, pe, weight, af_stats, remaining)
    return min(k, spec.max_chunk) if spec.max_chunk else k


def af_chunk_size(stats: AFStats, remaining: int, min_chunk: int = 1) -> int:
    """Adaptive Factoring chunk size (Banicescu & Liu 2000).

    K_j = (D + 2*T*R - sqrt(D^2 + 4*D*T*R)) / (2*mu_j), with R the
    remaining iterations.  With zero measured variance (D = 0) this
    degenerates to T*R/mu_j -- each PE's speed-proportional share of 1/P
    of the remainder; the variance term shrinks chunks when iteration
    times are noisy.  Not a pure function of ``i``: the distributed
    protocol feeds it the loop-pointer read it already performs for the
    drain fast path (see ``OneSidedRuntime.claim``).
    """
    R = max(int(remaining), 0)
    if R <= 0:
        return min_chunk
    mu = max(stats.mu, 1e-12)
    D = max(stats.D, 0.0)
    T = max(stats.T, 1e-12)
    k = (D + 2.0 * T * R - math.sqrt(D * D + 4.0 * D * T * R)) / (2.0 * mu)
    return max(int(math.ceil(k)), min_chunk)


def _chunk_size_closed(spec: LoopSpec, i: int, pe: int = 0,
                       weight: Optional[float] = None,
                       af_stats: Optional[AFStats] = None,
                       remaining: Optional[int] = None) -> int:
    t, N, P = spec.technique, spec.N, spec.P
    if t == "static":
        return int(math.ceil(N / P))
    if t == "ss":
        return spec.min_chunk
    if t == "gss":
        # Eq. 1: K'_i = ceil(((P-1)/P)^i * N/P)
        return max(int(math.ceil(((P - 1.0) / P) ** i * N / P)), spec.min_chunk)
    if t == "tss":
        # Eq. 2: K'_i = K_0 - i*C
        K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
        return max(K0 - i * C, Klast)
    if t == "af" and af_stats is not None and remaining is not None:
        return af_chunk_size(af_stats, remaining, spec.min_chunk)
    if t == "fac2" or (t == "af"):
        # Eq. 3: K'_i = ceil((1/2)^(floor(i/P)+1) * N/P).  AF without
        # telemetry (cold start, or the offline planner) takes this form.
        b = i // P + 1
        return max(int(math.ceil(0.5 ** b * N / P)), spec.min_chunk)
    if t in WEIGHTED:
        # WF inherits the transformed FAC2 function, scaled by the claimer's
        # relative weight (paper Table 2 last row).  The AWF family is the
        # same form with the live measured weight substituted for the
        # static one (timestep/batch/chunk granularity per variant).
        w = spec.weight(pe) if weight is None else weight
        b = i // P + 1
        base = 0.5 ** b * N / P
        return max(int(math.ceil(w * base)), spec.min_chunk)
    if t == "tfss":
        # TFSS (Chronopoulos 2005): batches of P chunks, each the mean of the
        # TSS chunks of that batch -- closed form via the TSS linear ramp.
        K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
        b = i // P
        mean = K0 - (b * P + (P - 1) / 2.0) * C
        return max(int(math.ceil(mean)), Klast)
    raise AssertionError(t)


def chunk_sizes_closed(spec: LoopSpec, idx, xp=np, weights_per_step=None):
    """Vectorized K'_i over an array of step indices.

    ``xp`` is numpy (the parameter mirrors the reference's signature).
    ``weights_per_step`` optionally
    supplies the claimer weight per step for WF/AWF.
    """
    k = _chunk_sizes_closed(spec, idx, xp, weights_per_step)
    return xp.minimum(k, spec.max_chunk) if spec.max_chunk else k


def _chunk_sizes_closed(spec: LoopSpec, idx, xp=np, weights_per_step=None):
    t, N, P = spec.technique, spec.N, spec.P
    idx = xp.asarray(idx)
    fidx = idx.astype(xp.float64 if xp is np else xp.float32)
    if t == "static":
        return xp.full_like(idx, int(math.ceil(N / P)))
    if t == "ss":
        return xp.full_like(idx, spec.min_chunk)
    if t == "gss":
        k = xp.ceil(((P - 1.0) / P) ** fidx * (N / P))
        return xp.maximum(k, spec.min_chunk).astype(idx.dtype)
    if t == "tss":
        K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
        return xp.maximum(K0 - idx * C, Klast).astype(idx.dtype)
    if t in FAC_FAMILY:
        # The batched planner is offline: the AWF variants take their
        # statically-known weights (or ``weights_per_step``), AF its FAC2
        # bootstrap -- there is no telemetry before execution.
        b = idx // P + 1
        base = (0.5 ** b.astype(fidx.dtype)) * (N / P)
        if t in WEIGHTED and weights_per_step is not None:
            base = base * xp.asarray(weights_per_step)
        k = xp.ceil(base)
        return xp.maximum(k, spec.min_chunk).astype(idx.dtype)
    if t == "tfss":
        K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
        b = idx // P
        mean = K0 - (b * P + (P - 1) / 2.0) * C
        return xp.maximum(xp.ceil(mean), Klast).astype(idx.dtype)
    raise AssertionError(t)


def max_steps_bound(spec: LoopSpec) -> int:
    """A safe upper bound on the number of scheduling steps S."""
    base = _max_steps_bound(spec)
    if spec.max_chunk:
        # capped steps deliver exactly max_chunk each; uncapped ones are
        # bounded by the technique's own bound
        return base + -(-spec.N // spec.max_chunk) + spec.P
    return base


def _max_steps_bound(spec: LoopSpec) -> int:
    t, N, P = spec.technique, spec.N, spec.P
    if t == "static":
        return P
    if t == "ss":
        return int(math.ceil(N / spec.min_chunk))
    if t == "gss":
        # K'_i >= 1, and the geometric part reaches < 1 after
        # i > ln(P/N)/ln(1-1/P); afterwards chunks are 1.
        if N <= P or P == 1:
            return N
        geo = int(math.ceil(math.log(N / P) / -math.log(1.0 - 1.0 / P))) + 1
        return geo + N  # ultra-safe: tail of 1s can cover the remainder
    if t in ("tss", "tfss"):
        K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
        return S + N // max(Klast, 1) + 1
    if t in FAC_FAMILY:
        # batch b assigns ~ half the remainder; <= P*log2(N) + tail of 1s.
        # Live AWF/AF weights can shrink chunks below the unweighted
        # halving assumed here -- ``plan`` grows its bound until covered,
        # and the runtimes loop until drained, so the bound stays safe.
        return P * (int(math.ceil(math.log2(max(N, 2)))) + 2) + P
    raise AssertionError(t)


# ---------------------------------------------------------------------------
# Two-level (hierarchical) topology math, shared by HierarchicalRuntime and
# the DES so the simulated schedule can never drift from the real one.
# ---------------------------------------------------------------------------

def node_blocks(P: int, nodes: int):
    """Contiguous PE blocks per node: (bounds, n_pes).

    Block ``n`` is ``[bounds[n], bounds[n+1])``; every block is non-empty
    for ``1 <= nodes <= P``.
    """
    bounds = [n * P // nodes for n in range(nodes + 1)]
    return bounds, [bounds[j + 1] - bounds[j] for j in range(nodes)]


def hierarchical_outer_spec(spec: LoopSpec, nodes: int) -> LoopSpec:
    """The super-chunk-level spec: ``spec.technique`` over nodes-as-PEs.

    Per-PE weights aggregate into node weights (sum == nodes).  min_chunk
    scales by the largest node so a super-chunk never starves a node's
    PEs; max_chunk is *not* lifted (it bounds per-PE work lost, and a
    super-chunk is drained by the whole node).
    """
    bounds, n_pes = node_blocks(spec.P, nodes)
    node_w = None
    if spec.weights is not None:
        sums = [sum(spec.weights[bounds[j]:bounds[j + 1]])
                for j in range(nodes)]
        tot = sum(sums) or 1.0
        node_w = tuple(s * nodes / tot for s in sums)
    return LoopSpec(spec.technique, N=spec.N, P=nodes, weights=node_w,
                    min_chunk=spec.min_chunk * max(n_pes))


def hierarchical_inner_spec(spec: LoopSpec, inner_technique: str,
                            bounds, node: int, size: int) -> LoopSpec:
    """The within-node spec for one super-chunk of ``size`` iterations.

    A weighted inner technique renormalizes the node's PE weights to sum
    to the node's PE count (the closed forms' convention).
    """
    n_pes = bounds[node + 1] - bounds[node]
    w = None
    if spec.weights is not None and inner_technique in WEIGHTED:
        sub = spec.weights[bounds[node]:bounds[node + 1]]
        tot = sum(sub) or 1.0
        w = tuple(x * n_pes / tot for x in sub)
    return LoopSpec(inner_technique, N=size, P=n_pes, weights=w,
                    min_chunk=min(spec.min_chunk, size),
                    max_chunk=spec.max_chunk)


# ---------------------------------------------------------------------------
# Recurrence forms (paper Table 2) -- the sequential master-side computation.
# ---------------------------------------------------------------------------

def chunk_series_recurrence(
    spec: LoopSpec, pe_sequence: Optional[Sequence[int]] = None
) -> list:
    """Full chunk series computed the classical way (master-worker).

    This is the paper's Table 2: the master tracks the remaining iterations
    ``R`` (and ``K_{i-1}`` for TSS) and serves one claim at a time -- the
    serialization the closed forms remove.  ``pe_sequence`` gives which PE
    claims at each step (needed by WF to pick the weight); defaults to
    round-robin.  Chunk sizes sum exactly to N (final chunk truncated).
    """
    t, N, P = spec.technique, spec.N, spec.P
    K0, Klast, S, C = tss_constants(N, P, spec.min_chunk)
    out = []
    R = N
    i = 0
    k_tss = None  # TSS: previous chunk (untruncated)
    batch_base = None  # FAC2/WF/TFSS: chunk size fixed at batch start
    while R > 0:
        pe = pe_sequence[i] if pe_sequence is not None else i % P
        if t == "static":
            k = int(math.ceil(N / P))
        elif t == "ss":
            k = spec.min_chunk
        elif t == "gss":
            k = max(int(math.ceil(R / P)), spec.min_chunk)
        elif t == "tss":
            k_tss = K0 if k_tss is None else max(k_tss - C, Klast)
            k = k_tss
        elif t in FAC_FAMILY:
            if i % P == 0:  # new batch: half the remainder, split P ways
                batch_base = max(int(math.ceil(R / (2.0 * P))), spec.min_chunk)
            k = batch_base
            if t in WEIGHTED:
                k = max(int(math.ceil(spec.weight(pe) * batch_base)), spec.min_chunk)
        elif t == "tfss":
            if i % P == 0:  # mean of this batch's P TSS ramp values
                first = K0 - i * C
                mean = first - (P - 1) / 2.0 * C
                batch_base = max(int(math.ceil(mean)), Klast)
            k = batch_base
        else:
            raise AssertionError(t)
        if spec.max_chunk:
            k = min(k, spec.max_chunk)
        k = min(k, R)
        out.append(k)
        R -= k
        i += 1
    return out


# ---------------------------------------------------------------------------
# Batched planner (beyond paper): closed form + prefix sum.
# ---------------------------------------------------------------------------

def plan(spec: LoopSpec, weights_per_step=None):
    """Materialize the whole schedule: (sizes, starts), both int64 numpy.

    sizes sum exactly to N; starts[i] = cumsum(sizes[:i]).  This is the
    vectorized realization of the paper's Step-1..3 protocol when claims are
    conflict-free (planning mode), used by the deterministic data-pipeline
    sharder and by tests as the ground truth partition.
    """
    S_hi = max_steps_bound(spec)
    while True:
        idx = np.arange(S_hi, dtype=np.int64)
        sizes = chunk_sizes_closed(spec, idx, np, weights_per_step).astype(np.int64)
        csum = np.cumsum(sizes)
        if len(csum) and csum[-1] >= spec.N:
            break
        # Small supplied weights can shrink chunks below the unweighted
        # halving the bound assumes; chunks are >= min_chunk >= 1, so
        # doubling (capped by N steps) always terminates.
        if weights_per_step is None or S_hi >= spec.N:
            raise ValueError("weights_per_step too short to cover the loop")
        S_hi = min(S_hi * 2, spec.N)
        if len(weights_per_step) < S_hi:
            weights_per_step = np.concatenate(
                [np.asarray(weights_per_step, dtype=np.float64),
                 np.ones(S_hi - len(weights_per_step))])
    # first index where cumulative >= N
    cut = int(np.searchsorted(csum, spec.N))
    sizes = sizes[: cut + 1].copy()
    csum = csum[: cut + 1]
    sizes[-1] -= int(csum[-1] - spec.N)  # truncate final chunk
    if sizes[-1] == 0:
        sizes = sizes[:-1]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return sizes, starts


def plan_torch(spec: LoopSpec, max_steps: Optional[int] = None,
               device=None):
    """On-device planner: returns (sizes, starts, n_valid) as torch tensors.

    Fixed-shape (padded to ``max_steps``); padding chunks have size 0.
    ``sizes``/``starts`` are int32 on ``device`` (default ``"cuda"``),
    ``n_valid`` a 0-d int32 tensor there.  The closed forms are evaluated
    in float64 on the host, because a device ``pow`` is not libm's and
    would move GSS's ceil at integer boundaries; the prefix sum and the
    clamp into [0, N) run on the device.
    """
    import torch

    device = torch.device("cuda" if device is None else device)
    S_hi = int(max_steps or max_steps_bound(spec))
    k = chunk_sizes_closed(spec, np.arange(S_hi, dtype=np.int64))
    sizes = torch.as_tensor(k.astype(np.int32), device=device)
    csum = torch.cumsum(sizes, 0, dtype=torch.int32)
    prev = csum - sizes  # exclusive prefix
    # clamp each chunk into [0, N): size = clip(N - prev, 0, size)
    sizes = torch.clamp(torch.minimum(sizes, spec.N - prev), min=0)
    starts = torch.clamp(prev, max=spec.N)
    n_valid = (sizes > 0).sum(dtype=torch.int32)
    return sizes, starts, n_valid


def scheduling_steps(spec: LoopSpec) -> int:
    """Number of scheduling steps S for the closed-form schedule."""
    return len(plan(spec)[0])
