"""Versioned chunk-level execution traces -- the replay data plane.

Port of ``repro.replay.trace``, transliterated: equal inputs give
byte-identical output in both packages.

A ``Trace`` is the recorded ground truth of one loop execution: one
``ChunkRecord`` per executed chunk (claiming PE, scheduling-step ordinal,
iteration range, start/end timestamps, claim latency) plus the session
header (technique, N, P, runtime, executor, native wall time).  Traces are
reconstructable from any runtime (one-sided / two-sided / hierarchical)
and any executor: the native executors stamp wall-clock timestamps, the
DES stamps its virtual clock -- the record shape is identical, which is
what lets ``repro_torch.replay.calibrate`` treat both uniformly.

Serialization is canonical JSONL (sorted keys, compact separators, one
record per line, header first): ``write -> read -> write`` is
byte-stable, the trace store's round-trip contract.  See DESIGN.md
Sec. 9 for the schema.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Iterable, List, Optional, Union

import numpy as np

#: Trace schema version.  Bump on any backward-incompatible record or
#: header change; ``Trace.from_jsonl`` rejects newer majors.
TRACE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ChunkRecord:
    """One executed chunk: who ran what, when, and what the claim cost."""

    pe: int
    step: int  # scheduling-step ordinal (-1 when the producer had none)
    start: int  # first iteration of the chunk
    size: int  # iterations executed
    t0: float  # execution start [s since loop start; DES: virtual clock]
    t1: float  # execution end
    lat: float  # claim (scheduling) latency paid to obtain the chunk

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def stop(self) -> int:
        return self.start + self.size

    def to_dict(self) -> dict:
        return {"kind": "chunk", "pe": self.pe, "step": self.step,
                "start": self.start, "size": self.size,
                "t0": self.t0, "t1": self.t1, "lat": self.lat}

    @classmethod
    def from_dict(cls, d: dict) -> "ChunkRecord":
        return cls(pe=int(d["pe"]), step=int(d.get("step", -1)),
                   start=int(d["start"]), size=int(d["size"]),
                   t0=float(d["t0"]), t1=float(d["t1"]),
                   lat=float(d.get("lat", 0.0)))


def _canon(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class Trace:
    """A recorded loop execution (header + per-chunk records)."""

    technique: str
    N: int
    P: int
    runtime: str
    executor: str
    wall_time: float  # native T_loop (the calibration target)
    records: List[ChunkRecord]
    min_chunk: int = 1  # spec chunk bounds: replay must schedule with them
    max_chunk: Optional[int] = None
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = TRACE_SCHEMA_VERSION

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_report(cls, report, meta: Optional[dict] = None) -> "Trace":
        """Build a trace from a ``SessionReport`` carrying ``chunk_times``.

        Works for every executor: serial/threads stamp wall-clock
        timestamps; the sim executor (``collect_trace=True``) stamps the
        DES virtual clock.
        """
        if not report.chunk_times:
            raise ValueError(
                "report has no chunk_times -- drain the session through an "
                "executor (serial/threads, or sim with collect_trace=True)")
        recs = [ChunkRecord.from_dict(d) for d in report.chunk_times]
        return cls(technique=report.technique, N=report.N, P=report.P,
                   runtime=report.runtime, executor=report.executor or "?",
                   wall_time=float(report.wall_time), records=recs,
                   min_chunk=report.min_chunk, max_chunk=report.max_chunk,
                   meta=dict(meta or {}))

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    def iters_covered(self) -> int:
        """Total iterations the records account for (== N when complete)."""
        return sum(r.size for r in self.records)

    def per_pe(self) -> List[List[ChunkRecord]]:
        out: List[List[ChunkRecord]] = [[] for _ in range(self.P)]
        for r in self.records:
            if r.pe >= len(out):  # grown sessions
                out.extend([] for _ in range(r.pe - len(out) + 1))
            out[r.pe].append(r)
        return out

    def claim_latencies(self) -> np.ndarray:
        return np.array([r.lat for r in self.records], dtype=np.float64)

    def window(self, t_from: float, t_to: Optional[float] = None) -> "Trace":
        """A sub-trace of the chunks live in ``[t_from, t_to)``.

        Keeps every record that *finished* after ``t_from`` (and started
        before ``t_to``, when given), rebasing timestamps so the window
        opens at 0 -- the shape ``calibrate`` expects.  This is the
        sliding-window view an online controller calibrates from: recent
        chunks reflect the current cost/speed regime, chunks from ten
        epochs ago may not.  ``N`` becomes the windowed iteration count
        and ``wall_time`` the window span, so fitted speeds and
        overheads come purely from live-window evidence.
        """
        recs = [r for r in self.records
                if r.t1 > t_from and (t_to is None or r.t0 < t_to)]
        rebased = [ChunkRecord(pe=r.pe, step=r.step, start=r.start,
                               size=r.size, t0=r.t0 - t_from,
                               t1=r.t1 - t_from, lat=r.lat) for r in recs]
        if rebased:
            span = max(r.t1 for r in rebased)
        else:
            span = 0.0
        return Trace(technique=self.technique,
                     N=max(sum(r.size for r in rebased), 1), P=self.P,
                     runtime=self.runtime, executor=self.executor,
                     wall_time=float(span), records=rebased,
                     min_chunk=self.min_chunk, max_chunk=self.max_chunk,
                     meta={**self.meta,
                           "window": [float(t_from),
                                      None if t_to is None else float(t_to)]},
                     version=self.version)

    def summary(self) -> str:
        return (f"trace {self.technique} N={self.N} P={self.P} "
                f"[{self.runtime}/{self.executor}] chunks={len(self.records)} "
                f"covered={self.iters_covered()} wall={self.wall_time:.4f}s")

    # ------------------------------------------------------------------
    # canonical JSONL serialization (byte-stable round trip)
    # ------------------------------------------------------------------
    def to_jsonl(self) -> str:
        header = {"kind": "trace_header", "version": self.version,
                  "technique": self.technique, "N": self.N, "P": self.P,
                  "runtime": self.runtime, "executor": self.executor,
                  "wall_time": self.wall_time, "min_chunk": self.min_chunk,
                  "max_chunk": self.max_chunk, "meta": self.meta}
        lines = [_canon(header)]
        lines += [_canon(r.to_dict()) for r in self.records]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace")
        header = json.loads(lines[0])
        if header.get("kind") != "trace_header":
            raise ValueError("first JSONL line must be the trace_header")
        ver = header.get("version")
        if ver is None or ver > TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported trace version {ver!r} "
                f"(this build reads <= {TRACE_SCHEMA_VERSION})")
        recs = []
        for ln in lines[1:]:
            d = json.loads(ln)
            if d.get("kind") == "chunk":
                recs.append(ChunkRecord.from_dict(d))
        return cls(technique=header["technique"], N=int(header["N"]),
                   P=int(header["P"]), runtime=header["runtime"],
                   executor=header["executor"],
                   wall_time=float(header["wall_time"]), records=recs,
                   min_chunk=int(header.get("min_chunk", 1)),
                   max_chunk=header.get("max_chunk"),
                   meta=header.get("meta", {}), version=ver)


class TraceStore:
    """A directory of JSONL traces, one file per recorded run.

    Filenames are derived from the header (or supplied); ``save`` never
    overwrites -- colliding names get a numeric suffix.
    """

    SUFFIX = ".jsonl"

    def __init__(self, root: Union[str, pathlib.Path]):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _default_name(self, trace: Trace) -> str:
        return (f"{trace.technique}-N{trace.N}-P{trace.P}"
                f"-{trace.runtime}-{trace.executor}")

    def save(self, trace: Trace, name: Optional[str] = None) -> pathlib.Path:
        base = re.sub(r"[^A-Za-z0-9._-]", "_",
                      name or self._default_name(trace))
        path = self.root / (base + self.SUFFIX)
        n = 1
        while path.exists():
            path = self.root / f"{base}.{n}{self.SUFFIX}"
            n += 1
        path.write_text(trace.to_jsonl())
        return path

    def load(self, name_or_path: Union[str, pathlib.Path]) -> Trace:
        p = pathlib.Path(name_or_path)
        if not p.exists():
            p = self.root / str(name_or_path)
        if not p.exists() and not str(name_or_path).endswith(self.SUFFIX):
            p = self.root / (str(name_or_path) + self.SUFFIX)
        return Trace.from_jsonl(p.read_text())

    def list(self) -> List[str]:
        return sorted(p.name for p in self.root.glob(f"*{self.SUFFIX}"))

    def __iter__(self) -> Iterable[Trace]:
        for name in self.list():
            yield self.load(name)


def load_trace(path_or_trace) -> Trace:
    """Coerce a Trace | path | JSONL text into a ``Trace``."""
    if isinstance(path_or_trace, Trace):
        return path_or_trace
    if isinstance(path_or_trace, pathlib.Path):
        return Trace.from_jsonl(path_or_trace.read_text())
    if isinstance(path_or_trace, str):
        if "\n" in path_or_trace or path_or_trace.lstrip().startswith("{"):
            return Trace.from_jsonl(path_or_trace)
        return Trace.from_jsonl(pathlib.Path(path_or_trace).read_text())
    raise TypeError(f"cannot load a Trace from {type(path_or_trace)!r}")
