"""Carry the JAX package's parameters into the port.

``params_from_numpy`` turns a parameter tree of the JAX package
(``repro.models.api.init_params``), given as numpy arrays, into the
port's parameters, so the two packages compute the same function:

  * the leading axis of each stacked layer subtree is unstacked into the
    port's list of per-layer dicts: ``layers`` along ``cfg.n_layers``, and
    for the enc-dec family ``enc_layers`` along ``cfg.enc_layers`` and
    ``dec_layers`` along ``cfg.n_layers`` (an MoE layer's expert leaves
    (L, E, d, ff) become (E, d, ff));
  * every other subtree (the hybrid's ``shared`` block, the norms, the
    embeddings) is carried as it is;
  * every weight keeps its ``x @ W`` orientation -- no transpose anywhere,
    since the port multiplies ``x @ W`` as the reference does;
  * bf16 arrays (numpy's ``bfloat16`` extension type) are reinterpreted
    bit for bit;
  * ``dtype=`` casts every floating leaf except those the reference keeps
    in f32 in any model (the SSM's ``A_log``, ``D`` and ``dt_bias``, the
    MoE's ``router``); ``cast`` does the same to the port's own params.

This is not ``core/weights.py``: that module holds the DLS workers'
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.tree import leaves

from .layers import MOE_F32_LEAVES
from .ssm import F32_LEAVES as SSM_F32_LEAVES

#: leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = SSM_F32_LEAVES + MOE_F32_LEAVES


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def _map(tree, fn, key=None):
    """``fn(leaf, name)`` over a tree of dicts and lists; ``name`` is the
    leaf's own key."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, key) for v in tree]
    return fn(tree, key)


def cast(params, dtype):
    """``params`` with every floating leaf in ``dtype``, except the leaves
    the reference keeps in f32 (``F32_LEAVES``)."""
    def leaf(t, name):
        if name in F32_LEAVES or not t.is_floating_point():
            return t
        return t.to(dtype)

    return _map(params, leaf)


def stacked_depths(cfg) -> dict:
    """The stacked layer subtrees of ``cfg``'s params: name -> (the
    config's field that gives its depth, the depth)."""
    if cfg.is_encdec:
        return {"enc_layers": ("enc_layers", cfg.enc_layers),
                "dec_layers": ("n_layers", cfg.n_layers)}
    return {"layers": ("n_layers", cfg.n_layers)}


def params_from_numpy(tree, cfg, device=None, dtype=None):
    """The port's params for ``cfg`` from the JAX package's tree of numpy
    arrays, on ``device`` (default ``"cuda"``), cast to ``dtype`` if given.
    """
    device = _build.target_device(device, "params_from_numpy")
    depths = stacked_depths(cfg)
    params = {k: _map(v, lambda a, _: _tensor(a, device))
              for k, v in tree.items() if k not in depths}
    for name, (field, depth) in depths.items():
        stacked = _map(tree[name], lambda a, _: _tensor(a, device))
        for leaf in leaves(stacked):
            if leaf.shape[0] != depth:
                raise ValueError(f"{name} leaves must lead with {field}={depth}, "
                                 f"got shape {tuple(leaf.shape)}")
        params[name] = [_map(stacked, lambda t, _, i=i: t[i]) for i in range(depth)]
    return params if dtype is None else cast(params, dtype)
