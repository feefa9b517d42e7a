#!/usr/bin/env python3
"""Time repro_torch's protocol kernel on one CUDA card, launch by launch.

    python3 scripts/time_protocol.py [--src DIR]

Times ``csrc/protocol.cu`` at each launch the DLS main path of
``chip_smoke.py`` makes: the claim loop over the 4,096 64x64 tiles of a
4096x4096 Mandelbrot image (CT 2000, the tiles' escape-iteration costs) at
P = the SM count for static, ss, gss, tss and fac2, and gss at (N=513,
P=3).  ``--src`` times the ``repro_torch`` of another checkout's ``src``
(default: this one), so one call can time two trees in turns; the timing
helpers (``repro_torch/device/protocol_timing.py``) always come from this
checkout.

For each launch it prints the granted steps, the kernel's device time
under ``torch.profiler``, the CUDA-event time per wrapper call back to back
and the host wall time of one ``claim_schedule`` call.  Where the tree's
protocol library has it, the chain floor follows (µs and cycles a grant).
The last line is one JSON object with every number.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

IMG, CT, TILE = 4096, 2000, 64
HELPERS = Path(__file__).resolve().parents[1] / "src/repro_torch/device/protocol_timing.py"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HELPERS.parents[2]),
                    help="the src directory of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    if not torch.cuda.is_available():
        print("time_protocol: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, mandelbrot
    from repro_torch.kernels.mandelbrot.persistent import mandelbrot_tile_costs

    # loaded from its file, so that ``repro_torch`` above may be another tree's
    spec = importlib.util.spec_from_file_location("protocol_timing", HELPERS)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)

    _build.build(["protocol", "mandelbrot"])
    P = torch.cuda.get_device_properties(0).multi_processor_count
    costs = mandelbrot_tile_costs(mandelbrot(IMG, ct=CT), TILE, TILE)
    rows = timing.protocol_times(timing.main_path_cases(len(costs), P), {len(costs): costs})
    for r in rows:
        print(f"protocol {r['technique']} N={r['N']} P={r['P']}: {r['steps']} steps, "
              f"{r['device_ms']!r} ms on the card ({r['device_us_per_step']!r} us/step); "
              f"{r['event_ms']!r} ms per wrapper call back to back; "
              f"{r['call_ms']!r} ms per claim_schedule call")
    floor = timing.chain_floor()
    if floor:
        print(f"chain floor: {floor['us_per_step']!r} us/step, "
              f"{floor['cycles_per_step']!r} cycles/step")
    print(json.dumps({"src": args.src, "device": torch.cuda.get_device_name(0),
                      "protocol": rows, "chain_floor": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
