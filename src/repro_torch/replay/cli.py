"""``python -m repro_torch.replay`` -- record / calibrate / predict / gantt.

The zero-to-replay path on one machine:

    python -m repro_torch.replay record --n 2000 --p 4 --technique fac2 \\
        --executor sim --het --store traces/
    python -m repro_torch.replay calibrate --trace traces/fac2-N2000-...jsonl
    python -m repro_torch.replay predict   --trace traces/fac2-N2000-...jsonl
    python -m repro_torch.replay gantt     --trace traces/fac2-N2000-...jsonl \\
        --svg gantt.svg

``record`` drains a real ``dls.loop`` session through the chosen executor
(sim: seeded synthetic workload, optionally a heterogeneous 2:1 speed
mix; serial/threads: a seeded sleep workload) and writes the captured
trace into a ``TraceStore``.

Port of ``repro.replay.cli``: the same subcommands, arguments, choices and
output.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import dls
from repro_torch.core.chunk_calculus import TECHNIQUES

from .calibrate import calibrate
from .gantt import gantt_ascii, save_svg
from .predict import predict, ranking_table
from .trace import Trace, TraceStore, load_trace


def _workers_arg(value: str):
    """--workers: an int or the literal 'auto' (rejected at parse time)."""
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {value!r}") from None


def _record(args) -> int:
    rng = np.random.default_rng(args.seed)
    sigma = np.sqrt(np.log(1.0 + args.cost_cov ** 2))
    costs = rng.lognormal(np.log(args.cost_mean) - sigma ** 2 / 2, sigma,
                          size=args.n)
    speeds = np.ones(args.p)
    if args.het:  # the paper's 2:1 fast/slow mix, scaled down
        speeds[args.p // 2:] = 0.5
    kw = {}
    if args.runtime == "hierarchical":
        kw.update(nodes=args.nodes, inner_technique=args.inner_technique)
    session = dls.loop(args.n, technique=args.technique, P=args.p,
                       runtime=args.runtime, **kw)
    if args.executor == "sim":
        report = session.execute(None, executor="sim", costs=costs,
                                 speeds=speeds, seed=args.seed,
                                 collect_trace=True)
    else:
        # Seeded sleep workload: per-iteration costs realized as real time.
        def work_fn(a, b):
            time.sleep(float(costs[a:b].sum()))

        report = session.execute(work_fn, executor=args.executor)
    meta = {"seed": args.seed, "het": bool(args.het)}
    if args.runtime == "hierarchical":
        meta.update(nodes=args.nodes, inner_technique=args.inner_technique)
    trace = Trace.from_report(report, meta=meta)
    store = TraceStore(args.store)
    path = store.save(trace, name=args.name)
    print(trace.summary())
    print(f"saved -> {path}")
    return 0


def _calibrate(args) -> int:
    calib = calibrate(load_trace(args.trace))
    print(calib.summary())
    print(f"claim latency: min={calib.claim_lat_min:.3e}s "
          f"mean={calib.claim_lat_mean:.3e}s  meas_cov={calib.meas_cov:.3f}")
    err = calib.percent_error()
    print(f"replay percent error (native {calib.native_T:.4f}s): {err:.2f}%")
    return 0


def _predict(args) -> int:
    runtimes = args.runtimes.split(",") if args.runtimes else None
    res = predict(load_trace(args.trace), runtimes=runtimes,
                  seed=args.seed, budget_s=args.budget,
                  max_sim_iters=args.max_sim_iters, workers=args.workers)
    calib = res["calibration"]
    print(calib.summary())
    print(f"replay percent error: {res['percent_error']:.2f}%")
    print(ranking_table(res["ranking"], native_T=calib.native_T))
    return 0


def _gantt(args) -> int:
    trace = load_trace(args.trace)
    if not args.no_ascii:
        print(gantt_ascii(trace, width=args.width))
    if args.svg:
        path = save_svg(trace, args.svg)
        print(f"svg -> {path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.replay",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("record", help="run a loop and record its trace")
    r.add_argument("--n", type=int, default=2000)
    r.add_argument("--p", type=int, default=4)
    r.add_argument("--technique", default="fac2", choices=TECHNIQUES)
    r.add_argument("--runtime", default="one_sided",
                   choices=("one_sided", "two_sided", "hierarchical"))
    r.add_argument("--nodes", type=int, default=2)
    r.add_argument("--inner-technique", default="ss")
    r.add_argument("--executor", default="sim",
                   choices=("sim", "serial", "threads"))
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--cost-mean", type=float, default=1e-4)
    r.add_argument("--cost-cov", type=float, default=0.3)
    r.add_argument("--het", action="store_true",
                   help="2:1 heterogeneous speed mix (sim executor)")
    r.add_argument("--store", default="traces")
    r.add_argument("--name", default=None)
    r.set_defaults(fn=_record)

    c = sub.add_parser("calibrate", help="fit DES params; report % error")
    c.add_argument("--trace", required=True)
    c.set_defaults(fn=_calibrate)

    q = sub.add_parser("predict", help="calibrated cross-technique sweep")
    q.add_argument("--trace", required=True)
    q.add_argument("--runtimes", default=None,
                   help="comma-separated (default: the trace's runtime)")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--budget", type=float, default=None,
                   help="sweep wall-clock budget [s] (default unbounded)")
    q.add_argument("--max-sim-iters", type=int, default=None)
    q.add_argument("--workers", type=_workers_arg, default=None,
                   help="sweep fan-out: an int, 'auto' (all cores), or "
                        "unset for the adaptive default (simulate_many)")
    q.set_defaults(fn=_predict)

    g = sub.add_parser("gantt", help="render a trace (ASCII and/or SVG)")
    g.add_argument("--trace", required=True)
    g.add_argument("--width", type=int, default=80)
    g.add_argument("--svg", default=None)
    g.add_argument("--no-ascii", action="store_true")
    g.set_defaults(fn=_gantt)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
