"""Shared helpers for the ``test_torch_*`` parity tests (repro vs repro_torch).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs as the JAX tests run it (CPU, Pallas in interpret mode), the
port side with ``device="cpu"`` -- each kernel's plain version.
"""
import numpy as np
import pytest


def require_card():
    """Skip the calling test unless a CUDA card and ``nvcc`` are present.

    Called inside tests marked ``cuda`` (never at import or collection
    time, so every worker collects the same tests).
    """
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from repro_torch.kernels import _build

    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the kernels: {e}")


def cloud(n, seed=0):
    """The point cloud of tests/test_kernels.py: normal points, unit normals."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm
