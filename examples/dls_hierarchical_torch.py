"""Port of ``examples/dls_hierarchical.py`` to ``repro_torch``: the same flags,
printed lines and asserts.

Two-level (hierarchical) DLS: node super-chunks + local sub-scheduling.

The follow-up to the source paper (arXiv:1903.09510) nests a cheap
node-local shared-memory window under the global RMA window: a node claims
a *super-chunk* through the global window with the outer technique's
closed form, then its PEs partition the super-chunk locally.  Only
super-chunk claims pay the global serialization point.

This example runs the same loop three ways and prints the per-level RMW
counts -- the claim-count reduction is the whole point:

  1. flat one-sided over a real thread pool (every claim is "global"),
  2. hierarchical over threads (GSS over nodes + SS within each node),
  3. both under the DES at the paper's 288-core heterogeneous mix.

Run:  PYTHONPATH=src python examples/dls_hierarchical_torch.py [--n 20000]
"""
import argparse
import threading

import numpy as np

from repro_torch import dls
from repro_torch.core import paper_cluster, psia_costs
from repro_torch.core.sim import PSIA_MEAN_COST


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=4)
    args = ap.parse_args()
    N, P, nodes = args.n, args.workers, args.nodes

    hits = np.zeros(N, np.int64)
    lock = threading.Lock()

    def work(a, b):
        with lock:
            hits[a:b] += 1

    # ---- flat: every claim pays the (simulated-cost) global window --------
    flat = dls.loop(N, technique="ss", P=P, window="sim")
    r_flat = flat.execute(work, executor="threads")
    assert (hits == 1).all()

    # ---- hierarchical: GSS super-chunks over nodes, SS within -------------
    hits[:] = 0
    hier = dls.loop(N, technique="gss", P=P, runtime="hierarchical",
                    nodes=nodes, window="sim")
    r_hier = hier.execute(work, executor="threads")
    assert (hits == 1).all()

    print("threads executor (real concurrency, clocked windows):")
    print("  flat :", r_flat.summary())
    print("  hier :", r_hier.summary())
    clocks = hier.runtime.window.clocks()
    print(f"  hier modeled window time: global={clocks['global']*1e6:.0f}us "
          f"local={clocks['local']*1e6:.0f}us "
          f"(global RMWs cut {r_flat.n_rmw_global / max(r_hier.n_rmw_global, 1):.0f}x)")

    # ---- the paper's 288-core heterogeneous mix, under the DES ------------
    speeds, _ = paper_cluster("2:1", "xeon")
    costs = psia_costs(N, mean=PSIA_MEAN_COST)
    des_flat = dls.loop(N, technique="ss", P=288).execute(
        None, executor="sim", costs=costs, speeds=speeds)
    des_hier = dls.loop(N, technique="gss", P=288, runtime="hierarchical",
                        nodes=8).execute(
        None, executor="sim", costs=costs, speeds=speeds)
    print("DES at the paper's 288-core 2:1 KNL/Xeon mix:")
    print("  flat :", des_flat.summary())
    print("  hier :", des_hier.summary())
    print(f"  global-RMW reduction: "
          f"{des_flat.n_rmw_global / max(des_hier.n_rmw_global, 1):.0f}x")


if __name__ == "__main__":
    main()
