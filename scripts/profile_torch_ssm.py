#!/usr/bin/env python3
"""Where the time of repro_torch's mamba2-370m goes on one CUDA card.

    python3 scripts/profile_torch_ssm.py [--reps 3] [--trace DIR]

Profiles, with ``torch.profiler`` (CUDA activity), at full width with
random weights from seed 0 in bf16:

  * the forward on B=4 prompts of 2048 tokens, ``backend="pallas"`` (the
    SSD scan kernel) and ``backend="xla"``;
  * the serving engine's decode step at B=16 after a 512-token prefill.

For each it prints the wall time per call, the device time the profiler
saw (kernels and copies), the device's busy share of the wall time, the
kernels that took the most device time, and the SSD scan's own kernels
(``ssd_*``) with their sum.  ``--trace`` also writes
Chrome traces.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def device_us(evt) -> float:
    """An event's own device time in microseconds (the attribute's name
    changed across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def on_device(evt) -> bool:
    """A kernel, copy or set on the card.  The operator rows (``aten::mul``)
    carry their kernels' time as well, so counting them would count it
    twice."""
    from torch.autograd import DeviceType

    return getattr(evt, "device_type", None) == DeviceType.CUDA and device_us(evt) > 0


def profile(what, fn, reps, trace_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages() if on_device(e)]
    dev_ms = sum(device_us(e) for e in events) / 1e3 / reps
    launches = sum(e.count for e in events) / reps
    print(f"\n== {what}: {wall_ms!r} ms wall per call, {dev_ms!r} ms device time "
          f"(busy {dev_ms / wall_ms!r} of the wall time), {launches!r} kernels "
          f"per call under {len(events)} names")
    ranked = sorted(events, key=device_us, reverse=True)
    # the top 12, then the scan's own kernels wherever they rank
    for e in ranked[:12] + [e for e in ranked[12:] if "ssd_" in e.key]:
        ms = device_us(e) / 1e3 / reps
        print(f"  {ms:10.4f} ms {ms / dev_ms:7.2%} x{e.count // reps:<6d} {e.key[:90]}")
    scan_ms = sum(device_us(e) for e in events if "ssd_" in e.key) / 1e3 / reps
    print(f"  the SSD scan's kernels together: {scan_ms!r} ms ({scan_ms / dev_ms:.2%})")
    if trace_dir:
        path = Path(trace_dir) / f"{what.split(':')[0].replace(' ', '_')}.json"
        prof.export_chrome_trace(str(path))
        print(f"  trace: {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="directory for Chrome traces")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_ssm: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import api

    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    cfg = get_config("mamba2-370m")
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 2048)).astype(np.int32)}
    with torch.no_grad():
        for backend in ("pallas", "xla"):
            profile(f"forward {backend}: B=4 x T=2048",
                    lambda: api.forward(params, cfg, batch, backend=backend),
                    args.reps, args.trace)
        prompts = rng.integers(0, cfg.vocab, (16, 512)).astype(np.int32)
        cache = api.init_cache(cfg, 16, 600, device=dev)
        logits, cache = api.prefill(params, cfg, {"tokens": prompts}, cache,
                                    backend="pallas")
        tok = logits.argmax(-1).int()
        profile("decode step: B=16 after a 512-token prefill",
                lambda: api.decode_step(params, cfg, tok, cache, backend="pallas"),
                args.reps * 10, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
