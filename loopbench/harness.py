"""One run of one cell: set-up, the timed window, the check, the result line.

Everything a cell needs is found by name:

  workloads/<cell>.json   its configuration, driver, traffic parameters and
                          the limits of the numbers its check compares
  configs/<config>.json   the configuration: source, widths, what was cut
  drivers/<driver>.py     ``Driver``: makes the inputs from the seed, drains
                          the loop once through the program's entry point,
                          and checks kept drains against the reference
  metrics/<metric>.py     ``read(ctx)``: one metric, or None where the run
                          holds nothing for it to read
  ../BENCHMARK.json       which metrics the cell reports

A run warms up with two drains, then drains back to back for ``seconds``;
each drain is timed on the host clock from the call until
``torch.cuda.synchronize()`` returns.  Between two drains the harness keeps
or poisons the last output and synchronizes again, so that none of its own
device work lands in the next drain's time.  A seeded reservoir keeps a few drains'
outputs, and once the window has closed and the memory peak has been read,
its ``Driver`` compares them with the reference.  ``--trace 1`` runs the same
window with the harness's spans on and ``torch.profiler`` over a stretch of
``trace_drains`` drains, and reports the per-layer metrics instead.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def driver_class(name: str):
    return importlib.import_module(f"loopbench.drivers.{name}").Driver


def reader(name: str):
    """``read`` of ``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"loopbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(cell: str, traced: bool) -> List[dict]:
    """The entries of BENCHMARK.json that ``cell`` reports: its end-to-end
    metrics, or with ``traced`` its per-layer ones."""
    bench = load_json(ROOT / "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if m["moves"] in names and cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Reservoir:
    """A uniform sample of ``k`` drains, drawn from the seed as they come."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, np.random.default_rng(seed), [], 0

    def offer(self, index: int, result):
        """Keep (index, result) or not; returns what is dropped (or None)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, result))
            return None
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            dropped, self.kept[j] = self.kept[j][1], (index, result)
            return dropped
        return result


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads."""

    drains_s: List[float]           # every drain of the window, host clock
    window_s: float                 # the drains' time, summed
    set_up_s: float
    work: List[dict]                # the Driver's work of each drain
    traced: List[int]               # drains inside the profiled stretch
    trace: object                   # trace.Summary, or None
    spans: Dict[str, list]          # the Driver's own spans

    def untraced(self) -> List[int]:
        t = set(self.traced)
        return [i for i in range(len(self.drains_s)) if i not in t]

    def least_s(self, indices, kernel: str) -> float:
        """Least seconds for ``kernel`` over the drains ``indices``."""
        from loopbench.reference.work import least_seconds

        w = [self.work[i]["kernels"][kernel] for i in indices]
        return sum(least_seconds(x["ops"], x["bytes"], x["rate"]) for x in w)


def _finite(v) -> float:
    """A compared number as a float; a missing or NaN one reads as inf."""
    if v is None:
        return float("inf")
    v = float(v)
    return v if v == v else float("inf")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(cell: str, seed: int, seconds: float, traced: bool, *, device="cuda",
        t_start: Optional[float] = None, overrides: Optional[dict] = None,
        log=None) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch

    from loopbench import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = torch.device(device)
    wl = workload(cell)
    cfg = config(wl["config"])
    params = {**wl["traffic"], **(overrides or {})}
    metrics = metrics_for(cell, traced)
    Driver = driver_class(wl["driver"])
    parts = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build(Driver.LIBRARIES)
        torch.cuda.init()
    parts["build_and_cuda"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    drv = Driver(params, cfg, seed, device, traced=traced)
    _sync(device)
    # the reference's own work in set-up is the check's, not the program's
    parts["reference"] = float(getattr(drv, "reference_s", 0.0))
    parts["inputs"] = time.perf_counter() - t0 - parts["reference"]
    for k in (-2, -1):                    # warm-up at the cell's own shapes
        t0 = time.perf_counter()
        drv.release(drv.drain(k))
        _sync(device)
        warm_s = parts[f"warm_up{k}"] = time.perf_counter() - t0
    prof = None
    if traced and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            drv.release(drv.drain(-1))    # the profiler's own start-up
            _sync(device)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    n_trace = int(params.get("trace_drains", 4))
    # the stretch starts about a third into the window
    trace_at = max(1, int(seconds / 3 / max(warm_s, 1e-3))) if prof is not None else -1
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = Reservoir(int(params.get("check_drains", 3)), seed)
    durations, stretch = [], []
    set_up_s = time.perf_counter() - t_start - parts["reference"]
    deadline = time.perf_counter() + seconds
    k = 0
    while True:
        if k == trace_at and prof is not None:
            prof.start()
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.record_function(tr.DRAIN_SPAN):
                out = drv.drain(k)
                _sync(device)
        else:
            out = drv.drain(k)
            _sync(device)
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        if prof is not None and trace_at <= k < trace_at + n_trace:
            stretch.append(k)
        dropped = res.offer(k, out)
        if dropped is not None:
            drv.release(dropped)
            _sync(device)
        del out, dropped
        k += 1
        if k == trace_at + n_trace and prof is not None:
            _sync(device)
            prof.stop()
        if t1 >= deadline and (prof is None or k >= trace_at + n_trace):
            break
    window_s = sum(durations)
    _sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    summary = tr.from_profiler(prof) if prof is not None else None
    del prof
    per_drain = drv.check(res.kept)
    limits = wl["limits"]
    numbers = {n: max((d.get(n) for d in per_drain), key=_finite) if per_drain else None
               for n in limits}
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    failed = sum(not all(_finite(d.get(n)) <= limits[n] for n in limits)
                 for d in per_drain) if per_drain else 1
    correct = failed == 0 and all(_finite(v) <= limits[n] for n, v in numbers.items())
    for c in checks.values():
        if _finite(c["value"]) == float("inf"):
            c["value"] = None             # JSON has no NaN or inf; None fails
    work = [drv.work(i) for i in range(len(durations))]   # after the check
    ctx = Ctx(durations, window_s, set_up_s, work, stretch, summary, drv.spans)
    out_metrics = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(durations), "failed": failed,
              "metrics": out_metrics, "device": dev}
    result["setup_parts"] = parts
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    log(f"cell {cell} seed {seed}: {len(durations)} drains taking {window_s!r} s, "
        f"set-up {set_up_s!r} s ({', '.join(f'{n} {v:.3f}' for n, v in parts.items())}), "
        f"{len(res.kept)} checked")
    q = np.percentile(durations, [0, 25, 50, 75, 95, 100]) * 1e3
    log("drain ms: min %.3f q1 %.3f median %.3f q3 %.3f p95 %.3f max %.3f" % tuple(q))
    for n, c in checks.items():
        log(f"check {n}: {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="time to drain a self-scheduled loop")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = int(workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"loopbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loopbench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
