"""What a drain has to compute, in operations and bytes, and the least time for it.

The arithmetic follows the repo's card script (``chip_smoke.py``: its
``bound`` and ``causal_pairs``, and the per-iteration and per-pair counts
beside them), frozen here so that a change to the program cannot move it:

* Mandelbrot: 14 f32 operations per escape iteration (z^2 3, z^4 4, + c 2,
  |z|^2 3, the compare and the count 2; |z|^2's two products are the next
  iteration's zr*zr and zi*zi), summed over the counts these inputs need;
  none pairs into an FMA, so the rate is half the f32 FMA rate.  Bytes:
  the int32 count written per pixel.
* Attention: 4*D operations per attended (row, key) pair (q.k and p.v, a
  multiply and an add each) at the bf16 tensor-core rate, over the pairs
  that the valid rows attend; padding rows have no answer and are not
  counted.  Bytes: q, k and v of the valid rows read once, out written once.

The least time is the larger of operations over the operation rate and
bytes over the memory rate (``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path

MANDEL_OPS_PER_ITER = 14
PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def least_seconds(ops: float, nbytes: float, rate: str) -> float:
    """The larger of ops / PEAKS[rate] and nbytes / the memory rate."""
    return max(ops / PEAKS[rate], nbytes / PEAKS["hbm_bytes_per_s"])


def mandelbrot(counts_sum: int, pixels: int) -> dict:
    return {"ops": MANDEL_OPS_PER_ITER * float(counts_sum), "bytes": 4.0 * pixels,
            "rate": "f32_nofma_ops_per_s"}


def attention(lengths, H: int, Hkv: int, D: int, itemsize: int = 2) -> dict:
    pairs = sum(int(L) * (int(L) + 1) // 2 for L in lengths)
    rows = sum(int(L) for L in lengths)
    return {"ops": 4.0 * D * H * pairs,
            "bytes": float(itemsize * D * rows * (2 * H + 2 * Hkv)),
            "rate": "bf16_flops_per_s"}
