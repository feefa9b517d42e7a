"""Import hygiene of the port: repro_torch and chip_smoke.py never import
``jax`` or the reference package ``repro`` (not even a numpy-only module),
nor ``ml_dtypes``, which the card's machine does not have."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PT_FILES = sorted((ROOT / "src" / "repro_torch" / "pt").glob("*.py"))


def test_pt_package_has_its_modules():
    assert {p.stem for p in PT_FILES} == {
        "__init__", "window", "worker", "executor", "workloads", "latency"}


@pytest.mark.parametrize("path", PT_FILES, ids=[p.name for p in PT_FILES])
def test_pt_module_imports_no_torch_at_top_level(path):
    """repro_torch.pt is stdlib-only at import time (spawn-safe workers that
    never bring CUDA up unless their work does): no module-level import of
    torch, nor of numpy."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    bad = [m for m in _imported_modules(ast.Module(body=top, type_ignores=[]))
           if m.split(".")[0] in ("torch", "numpy")]
    assert not bad, f"{path.name} imports {bad} at import time"


def test_importing_pt_loads_no_torch():
    """The whole import chain of repro_torch.pt (core, dls, policies) stays
    torch-free: a fresh interpreter imports it and finds no torch loaded."""
    import subprocess
    import sys

    code = ("import sys; import repro_torch.pt, repro_torch.pt.worker, "
            "repro_torch.pt.workloads, repro_torch.pt.latency; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
