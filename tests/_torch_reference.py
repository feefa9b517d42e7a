"""Run one of the reference's test files, unchanged and in place, against
the port: ``python -m pytest -p _torch_alias`` in a subprocess (see
``_torch_alias.py``), from the repository root.

``REFERENCE_FILES`` holds, per file, the least number of passes (counted
when the harness was committed) and the tests deselected by node id, each
with its reason: paths the port deliberately lacks, or artifacts of the
alias.  Nothing else is deselected.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX_BACKEND = "backend='jax' raises in the port by design (ROADMAP.md §3)"
_JAX_KEY = ("passes a jax.random key to api.init_params, whose port defaults to "
            "cuda; tests/test_torch_serve.py holds the same path")

#: file -> (least passes, {deselected test: reason})
REFERENCE_FILES = {
    "test_invariants.py": (40, {}),
    "test_dls_session.py": (68, {}),
    "test_scheduler.py": (16, {}),
    "test_hierarchical.py": (15, {}),
    "test_adaptive.py": (47, {}),
    "test_sim_regressions.py": (27, {}),
    "test_chunk_calculus.py": (46, {}),
    "test_sim_equivalence.py": (40, {}),
    "test_sim.py": (3, {}),
    "test_sim_fast.py": (147, {
        "test_jax_backend_close": _NO_JAX_BACKEND,
        "test_jax_backend_requires_x64": _NO_JAX_BACKEND,
    }),
    "test_serving.py": (21, {
        "test_generate_batch_independence": _JAX_KEY,
        "test_encdec_cross_kv_precompute_equals_recompute": _JAX_KEY,
        "test_plan_jax_inside_jit": "needs jax.jit around the planner",
    }),
    "test_workload.py": (33, {}),
    "test_replay.py": (31, {
        "test_cli_record_calibrate_predict_gantt":
            "runs python -m repro.replay in a subprocess, which the alias does "
            "not reach; tests/test_torch_replay.py holds the port's CLI",
    }),
    "test_pt.py": (19, {}),
    "test_fault_tolerance.py": (6, {}),
    # DeviceWindow defaults to cuda: without a card the module's skipif
    # skips all of it; the cuda-marked case runs it on the card
    "test_device.py": (0, {}),
    "test_kvstore_window.py": (0, {
        "test_kvstore_window_real_coordination_service":
            "JAX's coordination service; the port's KVStoreWindow uses the "
            "torch.distributed store (tests/test_torch_pt.py)",
    }),
    "test_docs.py": (5, {}),
}

#: files whose every test is deselected here: pytest collects none and
#: exits 5; the case still imports the file through the alias
NOTHING_LEFT = {"test_kvstore_window.py"}

#: on the card: test_device.py's least passes there, and the tests
#: deselected there: four import jax, which the card's machine does not
#: have; one passes the reference's Pallas tiling (``block_h``/``block_w``,
#: which the port's static entry has no counterpart of) and converts the
#: result, a CUDA tensor, with ``np.asarray`` (tests/test_torch_kernels.py's
#: cuda tests hold persistent == static on the card)
DEVICE_CARD_LEAST = 24
DEVICE_CARD_DESELECT = (
    "test_chunk_size_device_matches_host",
    "test_claim_schedule_resumes_from_nonzero_counters",
    "test_window_adopt_validates_shape",
    "test_fetch_add_traced_shim_matches_host_path",
    "test_mandelbrot_persistent_matches_static",
)


def run(path: str, tmp_path, deselect=(), timeout=180) -> dict:
    """Run ``tests/<path>`` through the alias; rc, counts, the plugin's check."""
    check_file = tmp_path / f"alias-check-{path}.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["REPRO_TORCH_ALIAS_CHECK"] = str(check_file)
    env["OMP_NUM_THREADS"] = "2"  # beside other test workers: no full OpenMP pool
    cmd = [sys.executable, "-m", "pytest", "-p", "_torch_alias", "-q",
           "-p", "no:cacheprovider", "-m", "not slow", f"tests/{path}",
           *[a for n in deselect for a in ("--deselect", f"tests/{path}::{n}")]]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|deselected|errors?)", tail)}
    chk = json.loads(check_file.read_text()) if check_file.exists() else None
    return {"rc": r.returncode, "counts": counts, "check": chk,
            "output": r.stdout[-4000:] + r.stderr[-2000:]}


def assert_reference_file(path: str, tmp_path) -> None:
    least, deselect = REFERENCE_FILES[path]
    got = run(path, tmp_path, deselect)
    assert got["rc"] == (5 if path in NOTHING_LEFT else 0), got["output"]
    assert got["check"] and got["check"]["ok"], (got["check"], got["output"])
    assert got["counts"].get("passed", 0) >= least, (got["counts"], got["output"])
