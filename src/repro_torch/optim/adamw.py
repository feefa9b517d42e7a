"""AdamW with optional gradient compression.

Port of ``repro.optim.adamw``.  The trees are the port's own (dicts and
lists of tensors, ``repro_torch.tree``); the state is ``{"m", "v",
"step"}`` with ``m``/``v`` shaped like the params and ``step`` a 0-d int32
tensor.  ``compress="bf16"`` casts the gradients to bf16 before the
update (the reference's pre-reduction cast), and ``state_dtype`` keeps
``m``/``v`` in f32 or bf16 while the update math runs in f32.

The reference's step donates params and state (``donate_argnums``), so
``update`` writes the new params and state into the tensors it was given,
under ``torch.no_grad()``, and returns them.  ``lr`` and the bias
corrections are f32, as ``jnp`` computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.tree import leaves, tree_map

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    compress: Optional[str] = None  # None | "bf16"
    # optimizer-state dtype: float32 (default) or bfloat16 (halves m/v;
    # the update math below stays f32)
    state_dtype: str = "float32"
    warmup_steps: int = 100
    schedule: str = "cosine"  # "cosine" | "constant"
    total_steps: int = 10_000


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a 0-d int tensor) as a 0-d f32
    tensor: linear warm-up, then constant or cosine decay."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def init(params, state_dtype=torch.float32):
    """Zero moments shaped like ``params`` on their devices, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)  # noqa: E731
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def init_for(cfg: AdamWConfig, params):
    """``init`` in the config's ``state_dtype``."""
    return init(params, STATE_DTYPES[cfg.state_dtype])


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step.  Returns (params, state, metrics) -- the tensors of
    ``params`` and ``state`` updated in place -- with ``grad_norm`` (before
    clipping) and ``lr`` in ``metrics``."""
    if cfg.compress == "bf16":
        grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
    grads = tree_map(lambda g: g.float(), grads)

    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    state["step"].add_(1)
    step = state["step"]
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, m, v, g):
        m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v.float() + (1 - cfg.b2) * g * g)
        mh = m.float() / b1c
        vh = v.float() / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    for p, m, v, g in zip(*(leaves(t) for t in (params, state["m"], state["v"], grads))):
        upd(p, m, v, g)
    return params, state, {"grad_norm": gnorm, "lr": lr}
