"""Gantt rendering of chunk traces (ASCII for terminals, SVG for CI).

Port of ``repro.replay.gantt``, transliterated: equal inputs give
byte-identical output in both packages.

One row per PE, one bar per executed chunk on the trace's clock (wall
for native executors, virtual for the DES).  The ASCII form cycles
per-chunk glyphs so adjacent chunks stay distinguishable; the SVG form
colors bars by scheduling-step ordinal (early = large chunks under
decreasing-chunk techniques), which makes the technique's shape visible
at a glance -- the paper's Fig. 3 style view of a run.
"""
from __future__ import annotations

import pathlib
from typing import List, Union

from .trace import Trace, load_trace

_GLYPHS = "#=@%+*o"


def _span(trace: Trace) -> float:
    end = max((r.t1 for r in trace.records), default=0.0)
    return max(end, trace.wall_time, 1e-12)


def gantt_ascii(trace, width: int = 80) -> str:
    """Terminal Gantt: one row per PE, ``.`` = idle, glyphs cycle per chunk."""
    tr = load_trace(trace)
    span = _span(tr)
    per_pe = tr.per_pe()
    lines = [f"{tr.summary()}  [1 col = {span / width:.3e}s]"]
    for pe, recs in enumerate(per_pe):
        row = ["."] * width
        for j, r in enumerate(sorted(recs, key=lambda x: x.t0)):
            a = int(r.t0 / span * width)
            b = int(r.t1 / span * width)
            b = max(b, a + 1)
            glyph = _GLYPHS[j % len(_GLYPHS)]
            for k in range(a, min(b, width)):
                row[k] = glyph
        lines.append(f"pe{pe:>3} |{''.join(row)}|")
    ticks = f"pe    |0{' ' * (width - len(f'{span:.3g}s') - 1)}{span:.3g}s|"
    lines.append(ticks)
    return "\n".join(lines)


def _bar_color(step: int, n_steps: int) -> str:
    """Early steps warm, late steps cool (HSL sweep, deterministic)."""
    frac = step / max(n_steps - 1, 1) if step >= 0 else 0.0
    hue = int(20 + 200 * frac)  # 20 (orange) -> 220 (blue)
    return f"hsl({hue},70%,55%)"


def gantt_svg(trace, width: int = 960, row_h: int = 18,
              margin: int = 56) -> str:
    """Standalone SVG Gantt (returned as text; save with ``save_svg``)."""
    tr = load_trace(trace)
    span = _span(tr)
    per_pe = tr.per_pe()
    P = len(per_pe)
    n_steps = max((r.step for r in tr.records), default=0) + 1
    H = row_h * P + 2 * margin
    W = width + 2 * margin
    parts: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
        f'viewBox="0 0 {W} {H}">',
        f'<rect width="{W}" height="{H}" fill="white"/>',
        f'<text x="{margin}" y="{margin - 28}" font-family="monospace" '
        f'font-size="13">{tr.technique} N={tr.N} P={tr.P} '
        f'[{tr.runtime}/{tr.executor}] chunks={len(tr.records)} '
        f'T={tr.wall_time:.4g}s</text>',
    ]
    for pe, recs in enumerate(per_pe):
        y = margin + pe * row_h
        parts.append(
            f'<text x="4" y="{y + row_h - 5}" font-family="monospace" '
            f'font-size="11">pe{pe}</text>')
        parts.append(
            f'<line x1="{margin}" y1="{y + row_h}" x2="{margin + width}" '
            f'y2="{y + row_h}" stroke="#ddd" stroke-width="0.5"/>')
        for r in recs:
            x = margin + r.t0 / span * width
            w = max((r.t1 - r.t0) / span * width, 0.5)
            parts.append(
                f'<rect x="{x:.2f}" y="{y + 2}" width="{w:.2f}" '
                f'height="{row_h - 4}" fill="{_bar_color(r.step, n_steps)}" '
                f'stroke="#333" stroke-width="0.3">'
                f'<title>pe{r.pe} step {r.step} [{r.start},{r.stop}) '
                f'{r.seconds:.4g}s</title></rect>')
    axis_y = margin + P * row_h + 14
    parts.append(
        f'<text x="{margin}" y="{axis_y}" font-family="monospace" '
        f'font-size="11">0</text>')
    parts.append(
        f'<text x="{margin + width - 40}" y="{axis_y}" '
        f'font-family="monospace" font-size="11">{span:.3g}s</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def save_svg(trace, path: Union[str, pathlib.Path],
             width: int = 960) -> pathlib.Path:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(gantt_svg(trace, width=width))
    return p
