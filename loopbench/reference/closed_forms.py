"""The chunk-size closed forms of the paper, frozen, and the checks of a schedule.

Step 2 of the paper's protocol (arXiv:1901.02773, Sec. 3 and Eq. 1-3):
a PE that fetched step index i computes its chunk K'_i alone, from i:

  static  ceil(N / P)
  ss      min_chunk
  gss     max(ceil(((P - 1) / P)**i * N / P), min_chunk)        (Eq. 1)
  fac2    max(ceil((1/2)**(i // P + 1) * N / P), min_chunk)     (Eq. 3)

evaluated in float64, as the paper's C code does.  Step 3 then grants
min(K'_i, N - start) at the loop pointer it fetched, so the grants
partition [0, N) whatever order the fetches came in.

numpy only: this module imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np

TECHNIQUES = ("static", "ss", "gss", "fac2")


def chunk_sizes(technique: str, i, N: int, P: int, min_chunk: int = 1) -> np.ndarray:
    """K'_i (int64) for every step index in ``i``."""
    i = np.asarray(i, dtype=np.int64)
    fi = i.astype(np.float64)
    if technique == "static":
        return np.full(i.shape, int(math.ceil(N / P)), np.int64)
    if technique == "ss":
        return np.full(i.shape, min_chunk, np.int64)
    if technique == "gss":
        k = np.ceil(((P - 1.0) / P) ** fi * (N / P))
    elif technique == "fac2":
        k = np.ceil(0.5 ** (i // P + 1).astype(np.float64) * (N / P))
    else:
        raise ValueError(f"no frozen closed form for {technique!r}; have {TECHNIQUES}")
    return np.maximum(k, min_chunk).astype(np.int64)


def plan(technique: str, N: int, P: int, min_chunk: int = 1):
    """(steps, starts, sizes) of the loop drained by one claimant at a time."""
    steps, starts, sizes, lp, i = [], [], [], 0, 0
    while lp < N:
        k = int(chunk_sizes(technique, [i], N, P, min_chunk)[0])
        steps.append(i)
        starts.append(lp)
        sizes.append(min(k, N - lp))
        lp += k
        i += 1
    return (np.asarray(steps, np.int64), np.asarray(starts, np.int64),
            np.asarray(sizes, np.int64))


def check_schedule(steps, starts, sizes, technique: str, N: int, P: int,
                   min_chunk: int = 1) -> dict:
    """The two numbers a schedule is held to, each 0 when it is sound.

    ``partition_errors``: grants of no iterations, and places where the
    grants, in order of their starts, leave a gap or overlap in [0, N).
    ``chunk_errors``: grants whose size is not min(K'_i, N - start), and
    step indices granted twice.
    """
    steps = np.asarray(steps, np.int64)
    starts = np.asarray(starts, np.int64)
    sizes = np.asarray(sizes, np.int64)
    if len(sizes) == 0:
        return {"partition_errors": 1, "chunk_errors": 0}
    order = np.argsort(starts, kind="stable")
    s, z = starts[order], sizes[order]
    ends = np.concatenate([[0], s + z])
    partition = int((z <= 0).sum()) + int((s != ends[:-1]).sum()) + int(ends[-1] != N)
    expect = np.minimum(chunk_sizes(technique, steps, N, P, min_chunk), N - starts)
    chunk = int((sizes != expect).sum()) + int(len(steps) - len(np.unique(steps)))
    return {"partition_errors": partition, "chunk_errors": chunk}
