"""Carry the JAX package's parameters into the port.

``params_from_numpy`` turns a parameter tree of the JAX package
(``repro.models.api.init_params``), given as numpy arrays, into the
port's parameters, so the two packages compute the same function:

  * the leading ``n_layers`` axis of ``tree["layers"]`` is unstacked into
    the port's list of per-layer dicts;
  * every weight keeps its ``x @ W`` orientation -- no transpose anywhere,
    since the port multiplies ``x @ W`` as the reference does;
  * bf16 arrays (numpy's ``bfloat16`` extension type) are reinterpreted
    bit for bit.

This is not ``core/weights.py``: that module holds the DLS workers'
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

from .lm import require_dense


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_numpy(tree, cfg, device=None, dtype=None):
    """The port's params for ``cfg`` from the JAX package's tree of numpy
    arrays, on ``device`` (default ``"cuda"``), cast to ``dtype`` if given.
    """
    require_dense(cfg)
    device = _build.target_device(device, "params_from_numpy")
    conv = lambda a: _tensor(a, device, dtype)  # noqa: E731
    stacked = _map(tree["layers"], conv)
    for leaf in _leaves(stacked):
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"layer leaves must lead with n_layers={cfg.n_layers}, "
                             f"got shape {tuple(leaf.shape)}")
    params = {k: conv(v) for k, v in tree.items() if k != "layers"}
    params["layers"] = [_map(stacked, lambda t, i=i: t[i])
                        for i in range(cfg.n_layers)]
    return params


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))
