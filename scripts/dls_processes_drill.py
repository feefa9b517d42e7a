"""Run ``examples/dls_processes_torch.py`` many times at once and tally its
kill run.

Each round starts ``--at-once`` copies of the example together (so the
host is loaded and a worker may start late), waits for all of them, and
the tally counts, over every run, the exit code and run 3's line: its
``iters=`` and the victim's ``salvaged=`` / ``orphaned=``.  A run is exact
when it exits 0 with ``iters`` equal to ``--n``, ``deaths=1`` and the
batch-0 split (``salvaged=16``, and ``orphaned`` the rest of the chunk).

    python scripts/dls_processes_drill.py [--root TREE] [--rounds 3]
        [--at-once 10] [--n 400] [--cost-us 50]

``--root`` names the checkout whose example and ``src`` are run (default:
this one), so one tree's drill can be compared with another's.
"""
import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path


def one_round(root: Path, k: int, n: int, cost_us: float) -> list:
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "examples/dls_processes_torch.py", "--n", str(n),
           "--cost-us", str(cost_us)]
    procs = [subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(k)]
    out = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        out.append((p.returncode, so, se))
    return out


def outcome(rc: int, out: str, err: str) -> str:
    kill = next((ln for ln in out.splitlines() if ln.startswith("PE 2 dies")), "")
    iters = re.search(r"iters=\d+", kill)
    deaths = re.search(r"deaths=\d+", kill)
    dead = re.search(r"salvaged=\d+ orphaned=\d+", out)
    tail = err.strip().splitlines()[-1] if rc and err.strip() else ""
    return " ".join(x[0] if isinstance(x, re.Match) else x
                    for x in (f"exit {rc}", iters, deaths, dead, tail) if x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--at-once", type=int, default=10)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--cost-us", type=float, default=50.0)
    args = ap.parse_args()
    root = args.root.resolve()
    tally = collections.Counter()
    for _ in range(args.rounds):
        for rc, out, err in one_round(root, args.at_once, args.n, args.cost_us):
            tally[outcome(rc, out, err)] += 1
    total = sum(tally.values())
    for line, count in tally.most_common():
        print(f"{count:4d} / {total}  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
