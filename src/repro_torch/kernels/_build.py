"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, from the sources in the checkout, into
``build/repro_torch/`` at the repository root.  A library's file name
carries a hash of its source, every header in ``csrc``, the flags and the
``nvcc`` (path and version), so a stale build is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once.  Builds
and first loads run under one lock, so threads whose first kernel calls
race (a thread pool rendering tiles) run each ``nvcc`` once.

Numeric trap 1 (FMA contraction) is handled by the flags: ``-fmad=false``
keeps every f32 product and sum separately rounded, as the reference's
double-float GSS and its bit-exact Mandelbrot and spin-image pins need.
``--use_fast_math`` must never be added: it also makes ``/`` and ``sqrtf``
approximate, which moves spin-image bins.

Every wrapper counts its launches in ``LAUNCHES`` (one per kernel launch,
nowhere else), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: library name -> CUDA source in ``csrc``
SOURCES = {
    "window": "window.cu",
    "protocol": "protocol.cu",
    "mandelbrot": "mandelbrot.cu",
    "spin_image": "spin_image.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "moe_experts": "moe_experts.cu",
    "mla_decode": "mla_decode.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {
    "window_fetch_add": 0,
    "protocol": 0,
    "claim_tables": 0,
    "mandelbrot_static": 0,
    "mandelbrot_persistent": 0,  # the table kernel ...
    "mandelbrot_persistent_claiming": 0,  # ... and the one whose CTAs claim for themselves
    "spin_image": 0,
    "flash_attention": 0,
    "flash_attention_persistent": 0,  # the (W, W) instances
    "flash_attention_persistent_full": 0,  # the wide full one ...
    "flash_attention_persistent_swa_sink": 0,  # ... and the wide SWA one with sinks
    "ssd_scan": 0,
    "moe_experts_up": 0,  # a layer's gate/up loop ...
    "moe_experts_down": 0,  # ... its down loop
    "moe_combine": 0,  # ... and its partial sum
    "mla_decode": 0,  # a latent-attention layer's split-KV loop ...
    "mla_decode_combine": 0,  # ... and the merge of its chunks
}

#: library name -> nvcc's output (``-Xptxas -v``: registers, shared memory)
BUILD_LOGS: Dict[str, str] = {}

# held by ``build`` and by the first call of ``library``/``function``: an
# ``lru_cache`` does not serialise first calls, and two threads' nvcc into
# one library would each ``os.replace`` the other's output
_LOCK = threading.RLock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    the toolkit's standard install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from src/repro_torch/csrc at first "
        "use")


@functools.lru_cache(maxsize=None)
def _compiler_id() -> str:
    """The ``nvcc`` in use and its ``--version``: a new toolkit is a new build."""
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    return f"{nvcc}\n{version}"


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_compiler_id().encode())
    for f in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every missing library of ``names`` in parallel; name -> path.

    Raises ``RuntimeError`` with nvcc's output if a source does not compile.
    """
    names = list(names)
    with _LOCK:
        paths = {n: _library_path(n) for n in names}
        todo = [n for n in names if not paths[n].exists()]
        if not todo:
            return paths
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {SOURCES[n]} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
        return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing)."""
    with _LOCK:
        return ctypes.CDLL(str(build([name])[name]))


@functools.lru_cache(maxsize=None)
def function(name: str, symbol: str, *argtypes):
    """A C entry point of library ``name`` with its argument types declared;
    every entry point returns ``cudaGetLastError()`` as an int."""
    with _LOCK:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def target_device(device, what: str):
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    A CUDA device needs a card: without one this raises, and never moves
    the work to the CPU.
    """
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA device (torch.cuda.is_available() is false); "
            "pass device='cpu' for the plain version")
    return device


def require_cuda(t, what: str, dtype, shape=None) -> None:
    """Validate a CUDA tensor handed to a kernel: dtype, shape, contiguity."""
    if not getattr(t, "is_cuda", False):  # a host array too
        raise ValueError(f"{what} must be a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
