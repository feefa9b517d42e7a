"""Readings that set a cell's limits, at the cell's own size, in one process.

    python3 loopbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--drains 3]

For every ``--seeds`` seed: the program's drains (``--drains`` of them,
back to back after one warm-up, each one kept) held to the reference, as a
run holds its kept drains.  For every ``--control-seeds`` seed: the
control, the reference put in the program's place and computed one
precision lower (the configuration's ``control_dtype``), held to the same
reference.  Prints one JSON line per seed and side, then a summary: the
largest reading of the program and the smallest of the control, number by
number.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import harness  # noqa: E402


def readings(cell: str, seeds, control_seeds, drains: int, device="cuda",
             overrides=None, log=print):
    """{"program": {name: [per seed]}, "control": {...}} of ``cell``."""
    import torch

    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    params = {**wl["traffic"], **(overrides or {})}
    Driver = harness.driver_class(wl["driver"])
    out = {"program": {}, "control": {}}
    for side, side_seeds in (("program", seeds), ("control", control_seeds)):
        for seed in side_seeds:
            t0 = time.perf_counter()
            drv = Driver(params, cfg, seed, torch.device(device))
            if side == "program":
                drv.release(drv.drain(-1))
                kept = [(k, drv.drain(k)) for k in range(drains)]
            else:
                kept = [(k, drv.control(k)) for k in range(drains)]
            nums = drv.check(kept)
            worst = {n: max(d[n] for d in nums) for n in nums[0]}
            for n, v in worst.items():
                out[side].setdefault(n, []).append(v)
            log(json.dumps({"cell": cell, "side": side, "seed": seed, **worst,
                            "seconds": time.perf_counter() - t0}))
            del drv, kept
            if device != "cpu":
                torch.cuda.empty_cache()
    summary = {n: {"program_max": max(out["program"].get(n, [float("nan")])),
                   "control_min": min(out["control"].get(n, [float("nan")]))}
               for n in set(out["program"]) | set(out["control"])}
    log(json.dumps({"cell": cell, "summary": summary}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--drains", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import _build

    _build.build(harness.driver_class(harness.workload(args.workload)["driver"]).LIBRARIES)
    readings(args.workload, args.seeds, args.control_seeds, args.drains)
    return 0


if __name__ == "__main__":
    sys.exit(main())
