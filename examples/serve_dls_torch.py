"""Port of ``examples/serve_dls.py`` to ``repro_torch``: the same printed
lines, and ``--device`` (default ``cuda``) for the model.

Serving with DLS continuous batching: real model, variable-length
requests, one-sided admission control.

A tiny LM serves a queue of requests with heavy-tailed generation lengths.
Decode groups claim request chunks via the paper's protocol; compare GSS
(decreasing chunks: big admissions early, small late -> tail-latency
control) against a static split.  The port's ``Engine`` takes no
``batch_size``: it decodes the batch it is given.

Run:  PYTHONPATH=src python examples/serve_dls_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serve import ContinuousBatcher, Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="serve-tiny", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, dtype="float32")
    params = api.init_params(0, cfg, device=args.device)
    eng = Engine(cfg, params)

    rng = np.random.default_rng(0)
    N_REQ = 48
    lens = np.clip((rng.pareto(1.2, N_REQ) * 8 + 2).astype(int), 2, 64)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, 8).astype(np.int32),
                    max_new=int(l)) for i, l in enumerate(lens)]
    print(f"[serve_dls] {N_REQ} requests, gen lengths p50={np.median(lens):.0f} "
          f"max={lens.max()}")

    # measure real per-token decode cost once (after a warmup)
    eng.generate(np.stack([r.prompt for r in reqs[:4]]), max_new=2)
    t0 = time.perf_counter()
    eng.generate(np.stack([r.prompt for r in reqs[:4]]), max_new=8)
    tok_cost = (time.perf_counter() - t0) / (4 * 8)

    def process(chunk, worker):
        """Cost of decoding a chunk of requests as one group (real cost model)."""
        return float(sum(r.max_new for r in chunk)) * tok_cost + 0.01

    for tech in ["gss", "fac2", "ss", "auto"]:
        cb = ContinuousBatcher(n_workers=4, technique=tech)
        t = cb.schedule(reqs, process)
        label = tech
        if tech == "auto":  # replay-predicted selection from the queue's shape
            label = f"auto->{cb.last_report.auto_decision['chosen']}"
        ts = cb.schedule(reqs, process, static=True)
        print(f"{label:10s}: makespan={t.max():.2f}s p99={np.percentile(t,99):.2f}s | "
              f"static: makespan={ts.max():.2f}s p99={np.percentile(ts,99):.2f}s")

    # and one real generation pass to prove the engine path end-to-end
    out = eng.generate(np.stack([r.prompt for r in reqs[:4]]), max_new=12)
    print(f"[serve_dls] real generation OK: {out.shape}")


if __name__ == "__main__":
    main()
