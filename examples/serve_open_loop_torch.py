"""Port of ``examples/serve_open_loop.py`` to ``repro_torch``: the same flags,
printed lines and asserts.

Open-loop serving scenario: traffic, SLOs, chaos, online re-selection.

Generates a seeded bursty request stream with heavy-tailed generation
lengths and two priority classes, then serves it three ways on the
simulated clock:

  1. a fixed GSS batcher (the closed-loop default),
  2. the same batcher with a worker death + straggler (chaos, measured
     in SLO terms -- requeues, TTFT tail, goodput),
  3. the online controller: ``technique="auto"`` bootstraps from the
     first batch's shape, then re-calibrates from its *live* chunk trace
     every second and switches technique when the predicted winner
     changes.

Run:  PYTHONPATH=src python examples/serve_open_loop_torch.py
"""
from repro_torch.serve import (
    SLO,
    ServeCostModel,
    TenantClass,
    generate_stream,
    run_scenario,
)
from repro_torch.sim import PEFailure, Straggler

stream = generate_stream(
    300, arrival="bursty", rate=60.0, seed=7,
    max_new_tail=1.1, max_new_scale=20.0, max_new_cap=512,
    tenants=[TenantClass("free", 0.7, 0), TenantClass("pro", 0.3, 2)])
print(f"[open_loop] {stream.summary()}")

cm = ServeCostModel(prefill_per_token=2e-5, tok_seconds=8e-4,
                    sched_overhead=0.03)
kw = dict(n_workers=4, cost_model=cm, slo=SLO(ttft_s=0.25), seed=0,
          keep_requests=False)

fixed = run_scenario(stream, technique="gss", **kw)
print(f"[fixed   ] {fixed.summary()}")
for name, t in sorted(fixed.slo.per_tenant.items()):
    print(f"           tenant {name}: n={t['n']} "
          f"ttft_p50={t['ttft_p50'] * 1e3:.0f}ms "
          f"attainment={t['attainment']:.2f}")

chaos = run_scenario(stream, technique="gss",
                     perturbations=(PEFailure(1, at=0.5),
                                    Straggler(2, at=0.2, factor=0.4)), **kw)
print(f"[chaos   ] {chaos.summary()}")
for e in chaos.chaos:
    print(f"           worker {e['worker']} died at t={e['t']:.2f}s: "
          f"salvaged {e['salvaged']}, requeued {e['requeued']}")

auto = run_scenario(stream, technique="auto", reselect_every_s=1.0, **kw)
print(f"[auto    ] {auto.summary()}")
for d in auto.reselections:
    arrow = "SWITCH" if d["switched"] else "keep"
    print(f"           t={d['t']:.2f}s epoch={d['epoch']}: "
          f"{d['from']} -> {d['to']} ({arrow})")
print(f"[open_loop] auto p99 TTFT {auto.slo.ttft['p99'] * 1e3:.0f}ms vs "
      f"fixed gss {fixed.slo.ttft['p99'] * 1e3:.0f}ms; "
      f"report bytes stable: "
      f"{run_scenario(stream, technique='auto', reselect_every_s=1.0, **kw).to_json() == auto.to_json()}")
