"""Sharding vocabulary shared by the model plane and the launcher.

Port of ``repro.shard.spec``.  The model code is written against
*logical* axes -- ``"batch"`` (the mesh's ``("pod", "data")``: the
activations' batch dim, the FSDP axis of the params) and ``"model"`` (TP:
heads, ffn hidden, experts, vocab) -- and marks its activations with
``cs`` only when a ``ShardCtx`` is active; under ``NO_SHARD`` (the
default) every hint is a no-op and the model runs on plain tensors.

Where the reference hands ``with_sharding_constraint`` to GSPMD, the port
uses PyTorch's own idiom: a ``DeviceMesh`` with named dims, ``DTensor``s
placed by ``Shard``/``Replicate``/``Partial``, and ``local_map`` around
each block's arithmetic (``local_call``), the counterpart of
``shard_map``.  ``P`` is a small ``PartitionSpec`` of the port's own: a
tuple with one entry per tensor dim, each a mesh axis name, a tuple of
them, or ``None``; ``pspec_to_placements`` turns it into the mesh-dim-wise
placements a ``DTensor`` takes.

``torch.distributed.tensor`` is imported inside the functions that need
it, so importing the model plane costs nothing extra.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the logical batch axes, outermost first
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``.

    A tuple, so specs compare as tuples (the reference's ``PartitionSpec``
    is one too)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Active logical->physical axis binding.  None axes mean 'replicated'."""

    batch_axes: Optional[Tuple[str, ...]] = None  # e.g. ("pod", "data")
    model_axis: Optional[str] = None  # e.g. "model"
    enabled: bool = True
    # physical sizes of the batch/model axes (for group-local algorithms
    # like the MoE dispatch, which need the data-parallel degree)
    batch_size_product: int = 1
    model_size: int = 1
    #: the ``DeviceMesh`` the placements refer to (None: no mesh)
    mesh: Optional[object] = None

    @property
    def batch(self):
        return self.batch_axes if self.batch_axes else None

    @property
    def model(self):
        return self.model_axis


#: disabled context used by CPU tests / smoke runs
NO_SHARD = ShardCtx(enabled=False)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size, read through ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_ctx(mesh) -> ShardCtx:
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    batch = tuple(n for n in names if n in BATCH_AXES)
    model = "model" if "model" in names else None
    bprod = 1
    for a in batch:
        bprod *= sizes[a]
    return ShardCtx(batch_axes=batch or None, model_axis=model,
                    batch_size_product=bprod, model_size=sizes.get("model", 1),
                    mesh=mesh)


def on_mesh(ctx: ShardCtx) -> bool:
    """Whether the model runs sharded: an enabled context with a mesh."""
    return ctx.enabled and ctx.mesh is not None


def _axes(entry) -> tuple:
    return () if entry is None else (tuple(entry) if isinstance(entry, tuple) else (entry,))


def fix_spec(spec, shape, sizes) -> P:
    """``spec`` keeping, for each dim, the longest prefix of its axes whose
    sizes divide the dim's extent; the rest of the dim is replicated."""
    out = []
    for dim, entry in enumerate(spec):
        keep, rem = [], shape[dim]
        for a in _axes(entry):
            if rem % sizes[a]:
                break
            keep.append(a)
            rem //= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def pspec_to_placements(spec, mesh) -> tuple:
    """"tensor dim -> mesh axes" as "mesh dim -> ``Shard(i)``/``Replicate()``".

    A dim sharded over two mesh axes, ``("pod", "data")``, is ``Shard(i)``
    on each of those mesh dims; they must come in the mesh's order (a
    ``DTensor`` shards the outer mesh dim first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def resolve(spec, ctx: ShardCtx) -> list:
    """Logical tokens "batch" / "model" resolved through the context."""
    return [ctx.batch if s == "batch" else ctx.model if s == "model" else s
            for s in spec]


def is_dtensor(x) -> bool:
    if not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def cs(x, *spec, ctx: ShardCtx):
    """Constrain ``x`` to ``P(*spec)``; no-op when ctx disabled.

    Spec entries are the *logical* tokens "batch" / "model" / None,
    resolved through the context.  Axes that do not divide their dim are
    dropped from it (``fix_spec``), where GSPMD would pad.  Under an
    enabled context ``x`` must be a ``DTensor``, which is redistributed
    to the placements; a plain tensor raises (it is never replicated
    silently).
    """
    if not ctx.enabled:
        return x
    resolved = resolve(spec, ctx)
    if all(r is None for r in resolved):
        return x  # fully replicated: constraint is a no-op (and needs no mesh)
    if ctx.mesh is None:
        raise ValueError(f"cs{tuple(spec)}: the sharding context has axes but no mesh")
    if not is_dtensor(x):
        raise TypeError(f"cs{tuple(spec)}: under a mesh the tensor must be a DTensor, "
                        f"got a plain {type(x).__name__} of shape {tuple(x.shape)}")
    placements = pspec_to_placements(
        fix_spec(resolved, x.shape, mesh_sizes(ctx.mesh)), ctx.mesh)
    return x if tuple(x.placements) == placements else x.redistribute(ctx.mesh, placements)


# ---------------------------------------------------------------------------
# local_map around a block's arithmetic
# ---------------------------------------------------------------------------


def model_coord(ctx: ShardCtx) -> Tuple[int, int]:
    """(this rank's index on the model axis, the axis's size)."""
    if ctx.model_axis is None:
        return 0, 1
    return ctx.mesh.get_local_rank(ctx.model_axis), ctx.model_size


def with_model(x, ctx: ShardCtx, placement):
    """``x``'s placements with the model mesh dim's replaced."""
    names = list(ctx.mesh.mesh_dim_names)
    pl = list(x.placements)
    if ctx.model_axis is not None:
        pl[names.index(ctx.model_axis)] = placement
    return tuple(pl)


def weight(w, ctx: ShardCtx, tp_dim: Optional[int]):
    """A weight as a block takes it: the FSDP (batch-axis) shards
    gathered, and on the model axis ``Shard(tp_dim)``, or ``Replicate()``
    where ``tp_dim`` is None."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(w):
        raise TypeError(f"under a mesh the params must be DTensors, got a plain "
                        f"tensor of shape {tuple(w.shape)}")
    sizes = mesh_sizes(ctx.mesh)
    # a mesh dim of size 1 holds the whole tensor whatever its placement
    pl = tuple(cur if sizes[n] == 1
               else Shard(tp_dim) if (n == ctx.model_axis and tp_dim is not None)
               else Replicate()
               for n, cur in zip(ctx.mesh.mesh_dim_names, w.placements))
    return w if tuple(w.placements) == pl else w.redistribute(ctx.mesh, pl)


def batch_split(x, ctx: ShardCtx) -> set:
    """The mesh axes along which ``x`` is sharded on its batch dim."""
    from torch.distributed.tensor import Shard

    return {n for n, p in zip(ctx.mesh.mesh_dim_names, x.placements)
            if n in BATCH_AXES and p == Shard(0)}


def local_call(fn, ctx: ShardCtx, out_placements, args, *, rows, tp=False):
    """``fn(*args)`` on each rank's local shards (``local_map``).

    The ranks' work differs along the batch axes that ``rows`` (the
    block's activation) is sharded on, and along the model axis where
    ``tp`` (the block splits its heads, ffn hidden, experts or vocab): an
    input replicated on such an axis gets a partial gradient there,
    summed across its ranks by the backward of the redistribution that
    brought it in.  Along the other axes every rank computes the same
    thing, and a replicated input's gradient is replicated.
    """
    from torch.distributed.tensor import DTensor, Partial, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    names = list(ctx.mesh.mesh_dim_names)
    split = batch_split(rows, ctx) | ({ctx.model_axis} if tp else set())

    def grad_pl(a):
        if not isinstance(a, DTensor):
            return None
        return tuple(Partial() if (p == Replicate() and n in split) else p
                     for n, p in zip(names, a.placements))

    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = (out_placements,)  # one output: a tuple of one
    flat = pytree.tree_leaves(args)
    return local_map(fn, out_placements=out_placements,
                     in_grad_placements=tuple(grad_pl(a) for a in flat),
                     device_mesh=ctx.mesh)(*args)


def local(x):
    """A ``DTensor``'s local shard; any other value as it is."""
    return x.to_local() if is_dtensor(x) else x


def batch_dtensor(t, ctx: ShardCtx):
    """``t`` (the same global tensor on every rank, or a ``DTensor``) with
    its batch dim sharded over the batch axes that divide it, replicated
    on the rest; a plain tensor is cut locally, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    spec = fix_spec(resolve(("batch",) + (None,) * (t.dim() - 1), ctx),
                    t.shape, mesh_sizes(ctx.mesh))
    placements = pspec_to_placements(spec, ctx.mesh)
    if is_dtensor(t):
        return t if tuple(t.placements) == placements else t.redistribute(ctx.mesh, placements)
    return distribute_tensor(t, ctx.mesh, placements, src_data_rank=None)
