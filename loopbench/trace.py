"""Reduce a ``torch.profiler`` stretch to what the per-layer readers need.

The stretch is the union of the ``loopbench.drain`` annotations the
profiler recorded: the drains' own time, without the harness's work between
two drains.  Device work is every kernel, copy and set on the card inside
it; the device is busy where any of them runs (their union), idle
elsewhere.  An idle gap is labelled with the
innermost host event the profiler recorded over its middle (an operator or
a runtime call), and where none is, with the operators that ended last
before its middle and started first after it: the host work between them,
such as a Python loop of the program, records no event of its own.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

DRAIN_SPAN = "loopbench.drain"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float                      # the stretch's length (its drains)
    busy_s: float                        # union of device work inside it
    n_drains: int                        # drain spans inside it
    op_s: Dict[str, float]               # device seconds by operation name
    gaps: List[Tuple[str, float]]        # the longest idle gaps, labelled

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of every operation whose name holds ``fragment``."""
        return sum(s for n, s in self.op_s.items() if fragment in n)

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:TOP]]}


def split_events(events):
    """(host, device, drains): (name, start_ns, end_ns) triples."""
    host, device, drains, cuda = [], [], [], []
    for e in events:
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if "CUDA" in str(e.device_type()):
            kind = getattr(e, "activity_type", None)
            cuda.append((name, t0, t1, kind() if kind is not None else None))
        elif name == DRAIN_SPAN:
            drains.append((name, t0, t1))
        else:
            host.append((name, t0, t1))
    # A torch whose events carry no activity type: a host range's projection
    # onto the device bears the range's name, and no kernel, copy or set does.
    annotations = {n for n, _, _ in host} | {DRAIN_SPAN}
    for name, t0, t1, kind in cuda:
        if kind in DEVICE_ACTIVITIES or (kind is None and name not in annotations):
            device.append((name, t0, t1))
    return host, device, drains


def _union(spans):
    """Sorted, disjoint (start, end) pairs covering ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(host, device, drains) -> Summary:
    """The stretch's numbers from the three event lists of ``split_events``."""
    if not drains:
        return Summary(0.0, 0.0, 0, {}, [])
    stretch = _union((t0, t1) for _, t0, t1 in drains)
    op_s: Dict[str, float] = {}
    busy, gaps = 0, []
    for lo, hi in stretch:
        spans = []
        for name, t0, t1 in device:
            a, b = max(t0, lo), min(t1, hi)
            if b > a:
                op_s[name] = op_s.get(name, 0.0) + (b - a) * 1e-9
                spans.append((a, b))
        cur = lo
        for a, b in _union(spans):
            busy += b - a
            if a > cur:
                gaps.append((cur, a))
            cur = b
        if cur < hi:
            gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    aten = [(n, t0, t1) for n, t0, t1 in host if n.startswith("aten::")] or host
    ops = (sorted((t1, n) for n, _, t1 in aten), sorted((t0, n) for n, t0, _ in aten))
    labelled = [(_label(a, b, host, ops), (b - a) * 1e-9) for a, b in gaps[:TOP]]
    window = sum(hi - lo for lo, hi in stretch)
    return Summary(window * 1e-9, busy * 1e-9, len(drains), op_s, labelled)


def _label(a: int, b: int, host, ops) -> str:
    mid = (a + b) // 2
    cover = [(t1 - t0, n) for n, t0, t1 in host if t0 <= mid <= t1]
    if cover:
        return min(cover)[1]
    ends, starts = ops
    i = bisect.bisect_right(ends, (mid, chr(0x10FFFF))) - 1
    j = bisect.bisect_left(starts, (mid, ""))
    before = ends[i][1] if i >= 0 else "start"
    after = starts[j][1] if j < len(starts) else "end"
    return f"{DRAIN_SPAN}: after {before}, before {after}"


def from_profiler(prof) -> Summary:
    return summarize(*split_events(prof.profiler.kineto_results.events()))
