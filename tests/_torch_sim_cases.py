"""Shared helpers for the DES parity tests (repro.sim vs repro_torch.sim).

The golden grid of ``_sim_golden_cases`` rebuilt with the port's classes,
and conversions of one package's ``SimConfig`` into the other's -- the
same arrays and plain fields, perturbations as the other's classes.
"""
import dataclasses
import json

import _sim_golden_cases as gc
import repro.core.chunk_calculus as jcc
import repro.core.sim as jsim
import repro_torch.core.chunk_calculus as tcc
import repro_torch.core.sim as tsim
from repro.sim import perturb as jpert
from repro_torch.core.weights import weights_from_speeds
from repro_torch.sim import perturb as tpert


def canon(r) -> str:
    """A ``SimResult`` as canonical JSON, every field the DES reports."""
    return json.dumps(gc.encode_result(r), sort_keys=True)


def port_config(case: dict) -> tsim.SimConfig:
    """``gc.build_config`` with the port's LoopSpec, SimConfig and weights."""
    speeds = gc._speeds(case["P"])
    weights = tuple(weights_from_speeds(speeds)) if case["weighted"] else None
    spec = tcc.LoopSpec(case["technique"], N=case["N"], P=case["P"],
                        weights=weights, min_chunk=case["min_chunk"],
                        max_chunk=case["max_chunk"])
    kw = dict(impl=case["runtime"], coordinator=case["coordinator"],
              seed=case["seed"],
              lock_polling_random=case["lock_polling_random"],
              collect_trace=True)
    if case["runtime"] == "hierarchical":
        kw["nodes"] = case["nodes"]
        kw["inner_technique"] = case["inner"]
    return tsim.SimConfig(spec, speeds, gc._costs(case["N"], case["cost_seed"]), **kw)


def _convert(cf, cc, sim, perturb):
    spec = cc.LoopSpec(**{f.name: getattr(cf.spec, f.name)
                          for f in dataclasses.fields(cf.spec)})
    kw = {f.name: getattr(cf, f.name) for f in dataclasses.fields(cf)
          if f.name != "spec"}
    if cf.perturbations is not None:
        kw["perturbations"] = tuple(
            getattr(perturb, type(p).__name__)(**dataclasses.asdict(p))
            for p in cf.perturbations)
    return sim.SimConfig(spec, **kw)


def to_port(cf: jsim.SimConfig) -> tsim.SimConfig:
    """The reference's SimConfig as the port's."""
    return _convert(cf, tcc, tsim, tpert)


def to_ref(cf: tsim.SimConfig) -> jsim.SimConfig:
    """The port's SimConfig as the reference's."""
    return _convert(cf, jcc, jsim, jpert)
