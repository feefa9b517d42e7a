"""Training step: CE loss, gradient accumulation over microbatches, remat.

Port of ``repro.train.step``.  ``make_train_step`` builds
    (params, opt_state, batch) -> (params, opt_state, metrics)
with the gradients from ``torch.autograd.grad`` over the param leaves and
the update in place (``optim.adamw.update``; the reference donates both
trees).  Microbatches run one after another, so only one microbatch's
activations are live (plus the remat policy inside the layer loop).

``loss_fn``, ``make_train_step`` and ``make_eval_step`` take the
reference's sharding context (``ctx``).  Under a mesh the params and the
optimizer state are ``DTensor``s (``repro_torch.shard.distribute``), the
batch is the same global tensors on every rank (each microbatch's rows are
cut to the batch shards where they are embedded, the reference's
``cs(x, None, "batch", ...)`` of its stacked microbatches), the gradients
come back in the params' placements, and the loss is the sum of the
ranks' token losses over their count.

The ``"pallas"`` backend's kernels are not differentiable (as the
reference's are not): a train step through it raises on its first call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import api
from repro_torch.shard.spec import (
    NO_SHARD, ShardCtx, batch_dtensor, cs, local_call, on_mesh)
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten


def ce_loss(logits, labels, mask=None):
    """Next-token cross entropy in f32.  logits (B,T,V); labels (B,T)."""
    lp = F.log_softmax(logits.float(), dim=-1)
    # shift: predict token t+1 from position t
    lp = lp[:, :-1]
    tgt = torch.as_tensor(labels, device=lp.device).long()[:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    if mask is not None:
        m = torch.as_tensor(mask, device=lp.device)[:, 1:].float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def _ce_sums(logits, labels, mask=None):
    """(the summed token losses, their count) of ``ce_loss``."""
    lp = F.log_softmax(logits.float(), dim=-1)[:, :-1]
    nll = -torch.gather(lp, -1, labels.long()[:, 1:, None])[..., 0]
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
    m = mask[:, 1:].float()
    return (nll * m).sum(), m.sum()


def loss_fn(params, cfg, batch, *, ctx: ShardCtx = NO_SHARD, backend="xla",
            remat="none"):
    logits = api.forward(params, cfg, batch, ctx=ctx, backend=backend, remat=remat)
    labels = batch["tokens"]
    logits = logits[:, -labels.shape[1]:]  # drop vlm prefix positions
    if not on_mesh(ctx):
        return ce_loss(logits, labels, batch.get("mask"))
    from torch.distributed.tensor import Partial, Replicate, Shard

    # each rank sums its rows' token losses over the whole vocab; the
    # sums are partial over the batch axes
    logits = cs(logits, "batch", None, None, ctx=ctx)
    labels = batch_dtensor(torch.as_tensor(labels, device=logits.device), ctx)
    mask = batch.get("mask")
    if mask is not None:
        mask = batch_dtensor(torch.as_tensor(mask, device=logits.device), ctx)
    pl = tuple(Partial() if p == Shard(0) else Replicate() for p in logits.placements)
    total, count = local_call(_ce_sums, ctx, (pl, pl), (logits, labels, mask), rows=logits)
    # replicated, so that every rank reads the loss (a partial sum reads its own part)
    loss = total / torch.clamp(count, min=1.0)
    return loss.redistribute(ctx.mesh, [Replicate()] * ctx.mesh.ndim)


def value_and_grad(params, cfg, batch, *, ctx: ShardCtx = NO_SHARD, backend="xla",
                   remat="none"):
    """(loss, grads shaped like ``params``): ``loss_fn`` and its gradient
    by ``torch.autograd.grad`` over the param leaves.  The params keep
    ``requires_grad`` false: the gradient is taken through detached
    aliases of their storage."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), cfg, batch, ctx=ctx, backend=backend,
                       remat=remat)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def _split(x, microbatches):
    """The interleaved split: microbatch j takes samples {k*mb + j}, so
    every data shard contributes equally to every microbatch."""
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} is not divisible into {microbatches} microbatches")
    x = torch.as_tensor(x)
    return [x[j::microbatches] for j in range(microbatches)]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, ctx: ShardCtx = NO_SHARD,
                    microbatches: int = 1, backend: str = "xla", remat: str = "none",
                    acc_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the two trees updated in place; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, cfg, batch, ctx=ctx, backend=backend,
                                         remat=remat)
        else:
            micro = {k: _split(v, microbatches) for k, v in batch.items()}
            loss = torch.zeros((), device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
            for j in range(microbatches):
                mb_loss, mb_grads = value_and_grad(
                    params, cfg, {k: v[j] for k, v in micro.items()},
                    ctx=ctx, backend=backend, remat=remat)
                grads = tree_map(lambda a, g: a + g.to(acc_dtype) / microbatches,
                                 grads, mb_grads)
                loss = loss + mb_loss / microbatches
        params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def make_eval_step(cfg, *, ctx: ShardCtx = NO_SHARD, backend="xla"):
    """Returns eval_step(params, batch) -> the loss, without grad."""
    @torch.no_grad()
    def step(params, batch):
        return loss_fn(params, cfg, batch, ctx=ctx, backend=backend)

    return step
