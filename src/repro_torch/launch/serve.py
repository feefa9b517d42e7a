"""Serving driver: batched generation + DLS continuous-batching stats.

Port of ``repro.launch.serve``.  On the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 64 --batch 8

``--reduced`` (the default) serves the reduced same-family config;
``--no-reduced`` serves at full width (the reference's flag is
``store_true`` with default true, so it can never be turned off).  On the
CPU add ``--device cpu``; without it the driver runs on ``"cuda"`` and
raises where there is no card.  The batcher's makespans are host
arithmetic over the same seed's request lengths, equal to the
reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import api
from repro_torch.serve import ContinuousBatcher, Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--technique", default="gss")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced() if args.reduced else get_config(args.arch)
    params = api.init_params(args.seed, cfg, device=args.device)
    eng = Engine(cfg, params)
    rng = np.random.default_rng(args.seed)

    # one real batched generation (throughput probe)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, 16)).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    if params["embed"].device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[serve] generated {out.shape} in {dt:.2f}s "
          f"({args.batch*args.max_new/dt:.1f} tok/s)")

    # DLS continuous-batching admission vs static split (simulated clock,
    # heavy-tailed generation lengths -- the variable-cost loop of serving)
    lens = (rng.pareto(1.5, size=args.requests) * 20 + 4).astype(int)
    reqs = [Request(rid=i, prompt=np.zeros(8, np.int32), max_new=int(l))
            for i, l in enumerate(lens)]

    def cost(chunk, worker):
        return float(sum(0.01 * r.max_new + 0.02 for r in chunk))

    cb = ContinuousBatcher(n_workers=args.batch, technique=args.technique)
    t_dls = cb.schedule(reqs, cost)
    t_static = cb.schedule(reqs, cost, static=True)
    print(f"[serve] makespan: DLS({args.technique})={t_dls.max():.2f}s "
          f"static={t_static.max():.2f}s  "
          f"p99 latency: {np.percentile(t_dls,99):.2f}s vs "
          f"{np.percentile(t_static,99):.2f}s")


if __name__ == "__main__":
    main()
