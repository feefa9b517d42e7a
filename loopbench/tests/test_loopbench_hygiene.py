"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program: checked in fresh interpreters."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for name in {modules!r}:
    importlib.import_module(name)
{extra}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(modules, extra=""):
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), modules=modules,
                         extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_run_path_loads_no_jax():
    drivers = sorted(p.stem for p in (ROOT / "loopbench" / "drivers").glob("[a-z]*.py"))
    extra = ("from loopbench import harness\n"
             "for p in sorted((harness.BENCH / 'metrics').glob('*.py')):\n"
             "    harness.reader(p.stem)\n")
    # the drivers import the program's entry points when they first drain
    entries = ["repro_torch.kernels.mandelbrot.persistent", "repro_torch.kernels",
               "repro_torch.kernels.flash_attention.persistent", "repro_torch.dls"]
    top = _loaded(["loopbench.harness", "loopbench.trace", "loopbench.control"]
                  + [f"loopbench.drivers.{d}" for d in drivers] + entries, extra)
    assert "repro_torch" in top and "loopbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    refs = sorted(p.stem for p in (ROOT / "loopbench" / "reference").glob("[a-z]*.py"))
    top = _loaded([f"loopbench.reference.{r}" for r in refs])
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_names_forbidden_modules(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from loopbench import harness

    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    bad = harness.forbidden_modules()
    assert "repro.core" in bad and "jaxlib" in bad
    assert not any(m.split(".")[0] == "repro_torch" for m in bad)
