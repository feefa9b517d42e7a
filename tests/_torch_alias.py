"""pytest plugin: the reference's own test files, unchanged, against the port.

    PYTHONPATH=src:tests python -m pytest -p _torch_alias tests/test_invariants.py

Loaded before collection, it makes ``import repro`` and ``import repro.X``
resolve to the port's ``repro_torch`` and ``repro_torch.X``: the module
objects themselves are registered in ``sys.modules`` under the alias names
(those already imported at once, the rest by a finder at first import).
Their ``__name__``, ``__spec__`` and ``__package__`` stay the port's:
importlib sets a loaded module's ``__spec__`` to the alias's spec, and the
finder's ``exec_module`` puts the port's own back before the import ends.

One name differs from the port: ``repro.core`` is a module of its own that
forwards every attribute to ``repro_torch.core`` and adds ``plan_jax``,
bound to ``functools.partial(plan_torch, device="cpu")`` (the port's
counterpart of the reference's on-device planner).  Nothing is set on
``repro_torch.core`` itself.

At session end, if ``$REPRO_TORCH_ALIAS_CHECK`` names a file, the plugin
writes its check there as JSON: no module in ``sys.modules`` was loaded
from ``src/repro/``, every ``repro``/``repro.*`` name maps to a module
whose ``__name__`` starts with ``repro_torch``, and every port module's
``__spec__`` names the module itself.
"""
import functools
import importlib
import importlib.abc
import importlib.util
import json
import os
import sys
import types
from pathlib import Path

ALIAS, PORT = "repro", "repro_torch"
CHECK_ENV = "REPRO_TORCH_ALIAS_CHECK"
REFERENCE_SRC = Path(__file__).resolve().parents[1] / "src" / ALIAS


def _port_name(alias: str) -> str:
    return PORT + alias[len(ALIAS):]


def _is_alias(name: str) -> bool:
    return name == ALIAS or name.startswith(ALIAS + ".")


def _is_port(name: str) -> bool:
    return name == PORT or name.startswith(PORT + ".")


class _CoreAlias(types.ModuleType):
    """``repro.core``: ``repro_torch.core``'s attributes, plus ``plan_jax``."""

    def __getattr__(self, name):
        return getattr(sys.modules[self.__name__], name)


def _core_alias():
    core = importlib.import_module(PORT + ".core")
    alias = _CoreAlias(core.__name__, core.__doc__)
    for attr in ("__file__", "__path__", "__package__", "__loader__", "__spec__"):
        setattr(alias, attr, getattr(core, attr))
    alias.plan_jax = functools.partial(core.plan_torch, device="cpu")
    return alias


def _register_imported() -> None:
    """Alias every port module imported so far (the import system then
    finds ``repro.X`` in ``sys.modules`` and loads nothing)."""
    for name, mod in list(sys.modules.items()):
        if _is_port(name) and mod is not None:
            sys.modules.setdefault(ALIAS + name[len(PORT):], mod)


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds ``repro.X`` not yet aliased: imports ``repro_torch.X`` and
    hands that module to the import system as ``repro.X``."""

    def __init__(self):
        self._specs = {}  # alias name -> the port module's own spec

    def find_spec(self, name, path=None, target=None):
        if not _is_alias(name):
            return None
        port = importlib.import_module(_port_name(name))
        return importlib.util.spec_from_loader(
            name, self, is_package=hasattr(port, "__path__"))

    def create_module(self, spec):
        port = sys.modules[_port_name(spec.name)]
        self._specs[spec.name] = port.__spec__
        return port

    def exec_module(self, module):
        module.__spec__ = self._specs.pop(module.__spec__.name)
        _register_imported()


def check() -> dict:
    """The plugin's check over ``sys.modules`` (see the module docstring)."""
    problems = []
    for name, mod in list(sys.modules.items()):
        if mod is None:
            continue
        f = getattr(mod, "__file__", None)
        if f and Path(f).resolve().is_relative_to(REFERENCE_SRC):
            problems.append(f"{name} loaded from the reference: {f}")
        if _is_alias(name) and not _is_port(getattr(mod, "__name__", "")):
            problems.append(f"{name} -> {getattr(mod, '__name__', None)}")
        spec = getattr(mod, "__spec__", None)
        if _is_port(name) and (spec is None or spec.name != mod.__name__):
            problems.append(f"{name}.__spec__ names {getattr(spec, 'name', None)}")
    aliases = sorted(n for n in sys.modules if _is_alias(n))
    return {"ok": not problems and bool(aliases), "aliases": aliases,
            "problems": problems}


def _install() -> None:
    if any(isinstance(f, _AliasFinder) for f in sys.meta_path):
        return
    if ALIAS in sys.modules and not _is_port(sys.modules[ALIAS].__name__):
        raise RuntimeError(f"{ALIAS} was imported before the alias plugin loaded")
    sys.modules[ALIAS + ".core"] = _core_alias()
    sys.modules[ALIAS] = importlib.import_module(PORT)
    _register_imported()
    sys.meta_path.insert(0, _AliasFinder())


_install()


def pytest_sessionfinish(session, exitstatus):
    out = os.environ.get(CHECK_ENV)
    if out:
        Path(out).write_text(json.dumps(check()))
