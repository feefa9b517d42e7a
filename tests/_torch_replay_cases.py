"""Shared inputs of the replay and serving parity tests (repro vs repro_torch).

``pkg(name)`` gathers one package's modules, so a test drives the same
case through ``repro`` and ``repro_torch`` and compares the bytes.  The
workloads are those of ``tests/test_replay.py`` (seeded lognormal costs
over a 2:1 speed mix).

The PSIA fixture (``fixtures/torch_replay_psia.json``) is written by the
JAX package:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_replay_cases.py

It holds, for a gss and a fac2 sim trace at the paper's PSIA size
(288,000 images, 288 PEs of the 2:1 KNL/Xeon mix, coordinator on a KNL,
``psia_costs()``, seed 0), the calibrated replay's percent error (as
``repr``) and the full-N ``predict`` ranking as (technique, ``repr(T_loop)``,
steps).  ``chip_smoke.py`` holds the port to it on the card's machine,
which has no JAX; ``test_torch_replay_psia.py`` regenerates the gss entry
from both packages here.
"""
import importlib
import json
import pathlib
import types

import numpy as np

N, P, SEED = 2_000, 4, 0

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_replay_psia.json"
FIXTURE_VERSION = 1
PSIA_N, PSIA_P, PSIA_SEED = 288_000, 288, 0
PSIA_TECHNIQUES = ("gss", "fac2")


def pkg(name: str) -> types.SimpleNamespace:
    """One package's modules: ``pkg("repro")`` or ``pkg("repro_torch")``."""
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, dls=mod("dls"), replay=mod("replay"), serve=mod("serve"),
        sim=mod("sim"), core_sim=mod("core.sim"),
        cc=mod("core.chunk_calculus"))


def both():
    return pkg("repro"), pkg("repro_torch")


def workload(n=N, seed=SEED, mean=1e-3, cov=0.3):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log(1 + cov * cov))
    return rng.lognormal(np.log(mean) - sigma**2 / 2, sigma, size=n)


def het_speeds(p=P):
    s = np.ones(p)
    s[p // 2:] = 0.5
    return s


def sim_trace(k, technique="fac2", runtime="one_sided", n=N, p=P, seed=SEED,
              **loop_kw):
    """tests/test_replay.py's ``_sim_trace`` through package ``k``."""
    session = k.dls.loop(n, technique=technique, P=p, runtime=runtime,
                         **loop_kw)
    report = session.execute(None, executor="sim", costs=workload(n),
                             speeds=het_speeds(p), seed=seed,
                             collect_trace=True)
    return k.replay.Trace.from_report(report, meta={"seed": seed}), report


def strip_wall_clock(obj):
    """Drop ``sweep_s`` (measured wall time) at every level of a record."""
    if isinstance(obj, dict):
        return {kk: strip_wall_clock(v) for kk, v in obj.items()
                if kk != "sweep_s"}
    if isinstance(obj, list):
        return [strip_wall_clock(v) for v in obj]
    return obj


def calibration_fields(cal) -> dict:
    """Every ``Calibration`` field, arrays as lists (for == across packages)."""
    return {f: (v.tolist() if isinstance(v, np.ndarray) else v)
            for f, v in cal.__dict__.items()}


def psia_trace(k, technique):
    """A sim trace at the paper's PSIA size through package ``k``."""
    speeds, coord = k.core_sim.paper_cluster("2:1", "knl")
    rep = k.dls.loop(PSIA_N, technique, P=PSIA_P).execute(
        None, executor="sim", costs=k.core_sim.psia_costs(), speeds=speeds,
        seed=PSIA_SEED, coordinator=coord, collect_trace=True)
    return k.replay.Trace.from_report(rep, meta={"seed": PSIA_SEED})


def psia_entry(k, technique, workers=0) -> dict:
    """The fixture's entry for one technique: percent error and ranking."""
    tr = psia_trace(k, technique)
    res = k.replay.predict(tr, seed=PSIA_SEED, budget_s=None, workers=workers)
    return {"records": len(tr.records),
            "percent_error": repr(res["percent_error"]),
            "ranking": [[p.technique, repr(p.T_loop), p.steps]
                        for p in res["ranking"]]}


def psia_fixture(k) -> dict:
    return {"version": FIXTURE_VERSION,
            "config": {"N": PSIA_N, "P": PSIA_P, "mix": "2:1",
                       "coordinator_on": "knl", "costs": "psia_costs()",
                       "seed": PSIA_SEED, "workers": 0},
            "traces": {t: psia_entry(k, t) for t in PSIA_TECHNIQUES}}


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    FIXTURE.write_text(json.dumps(psia_fixture(pkg("repro")), indent=1) + "\n")
    print(f"wrote {FIXTURE}")
