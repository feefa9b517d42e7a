"""Parameter / activation / cache sharding rules for the production mesh.

Port of ``repro.shard.rules``, line for line, over the port's trees (dicts
and lists of tensors, ``repro_torch.tree``).  Scheme (MaxText-style 2D):
every weight matrix is sharded
  * on the **model** axis along its TP dimension (heads, ffn hidden,
    experts, vocab), and
  * on the **fsdp** axis (= the mesh "data" axis) along the other dimension
    (ZeRO-3: params, grads and optimizer states all carry the same specs).
The "pod" axis is pure DP by default (gradients all-reduce across pods;
params replicated pod-wise) -- cross-pod FSDP would put per-layer
all-gathers on the slow inter-pod links.  `fsdp_pods=True` flips that
trade-off for models that do not fit one pod's HBM.

Rules match leaves by their path of dict keys; where the reference stacks
a layer subtree on a leading axis (and gives its leaves a leading None),
the port keeps a list of per-layer dicts, so a layer's leaf has the
reference's spec without that None.  The functions read a mesh through
``mesh_dim_names`` and ``shape`` only, so any object with those two
attributes will do.

``to_shardings``/``shardings_for`` return each leaf's ``DTensor``
placements (where the reference returns ``NamedSharding``s), and
``distribute`` places a tree of tensors on the mesh.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.tree import leaves, unflatten

from .spec import P, fix_spec, mesh_sizes, pspec_to_placements


def _rule_for(path_keys, leaf_ndim, *, fsdp: Optional[str], tp: Optional[str]):
    """PartitionSpec for one param leaf, *excluding* any stacked-layer dims."""
    name = path_keys[-1]
    parent = path_keys[-2] if len(path_keys) >= 2 else ""

    # ---- embeddings / head ----
    if name == "embed":
        return P(tp, fsdp)  # (vocab, d)
    if name == "lm_head":
        return P(fsdp, tp)  # (d, vocab)

    # ---- attention ----
    if name in ("wq", "wk", "wv"):
        return P(fsdp, tp)  # (d, heads*hd) column-parallel
    if name == "wo":
        return P(tp, fsdp)  # (heads*hd, d) row-parallel

    # ---- dense mlp ----
    if name in ("wg", "wu") and parent != "moe":
        return P(fsdp, tp)  # (d, ff)
    if name == "wd" and parent != "moe":
        return P(tp, fsdp)  # (ff, d)

    # ---- moe ----
    if name == "router":
        return P(fsdp, None)  # (d, E) small; replicate E
    if parent == "moe" or (len(path_keys) >= 2 and "moe" in path_keys):
        if name in ("wg", "wu"):
            return P(tp, fsdp, None)  # (E, d, ff): expert-parallel
        if name == "wd":
            return P(tp, None, fsdp)  # (E, ff, d)

    # ---- ssm ----
    if name == "in_proj":
        return P(fsdp, tp)  # (d, 2di+2S+H)
    if name == "out_proj":
        return P(tp, fsdp)  # (di, d)
    if name == "conv_w":
        return P(None, tp)  # (cw, di+2S)
    if name in ("conv_b", "norm_w"):
        return P(tp)
    if name in ("A_log", "D", "dt_bias"):
        return P(None)

    # ---- norms & anything 1-D ----
    if leaf_ndim == 1:
        return P(None)
    return P(*([None] * leaf_ndim))


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching leaves)`` over a tree of dicts and lists;
    ``path`` holds the dict keys only (a list index is no key, as a
    stacked axis is none in the reference's paths)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, *xs, path=path) for xs in zip(tree, *rest))
    return fn(path, tree, *rest)


def params_pspecs(params_tree, *, fsdp="data", tp="model", fsdp_pods=False):
    """PartitionSpec tree matching ``params_tree`` (tensors, ``meta`` ones
    included)."""
    fsdp_axes = ("pod", fsdp) if fsdp_pods else fsdp

    def visit(keys, leaf):
        spec = _rule_for(list(keys), leaf.dim(), fsdp=fsdp_axes, tp=tp)
        # guard: spec rank must match
        if len(spec) != leaf.dim():
            spec = P(*(list(spec) + [None] * (leaf.dim() - len(spec)))[: leaf.dim()])
        return spec

    return _map_with_path(visit, params_tree)


def resolve_batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _batch_entry(extent, axes, sizes):
    """The batch axes that divide ``extent`` in turn (none: replicate)."""
    use, rem = [], extent
    for a in axes:
        if rem % sizes[a] == 0:
            use.append(a)
            rem //= sizes[a]
    return tuple(use) if len(use) > 1 else (use[0] if use else None)


def batch_pspecs_for_mesh(batch_tree, mesh):
    axes = resolve_batch_axes(mesh)
    sizes = mesh_sizes(mesh)

    def visit(_, leaf):
        spec = [None] * leaf.dim()
        if leaf.dim() >= 1 and axes:
            # shard the batch dim over as many of (pod, data) as divide it
            # (long_500k has global_batch=1: fully replicated)
            spec[0] = _batch_entry(leaf.shape[0], axes, sizes)
        return P(*spec)

    return _map_with_path(visit, batch_tree)


def cache_pspecs(cache_tree, mesh, *, tp="model", kv_heads: Optional[int] = None):
    """KV/SSM caches: batch dim on data axes, heads (or head_dim) on model.

    Cache leaves: kv (L, B, S, Hkv, hd); ssm state (L, B, H, S, P);
    conv (L, B, cw-1, C); pos scalar.

    GQA wrinkle: when Hkv < |model| (e.g. qwen3's kv=4 on a 16-way TP axis),
    sharding the head dim would pad it |model|/Hkv-fold.  In that case we
    shard ``hd`` instead (attention then reduces partial sums over model).
    """
    axes = resolve_batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    tp_size = sizes.get(tp, 1)
    heads_ok = kv_heads is None or (kv_heads % tp_size == 0)

    def visit(keys, leaf):
        if leaf.dim() == 0:
            return P()
        if "conv" in keys:
            return P(None, _batch_entry(leaf.shape[1], axes, sizes), None, tp)
        if "state" in keys:
            return P(None, _batch_entry(leaf.shape[1], axes, sizes), tp, None, None)
        if leaf.dim() == 5:  # kv / cross kv: (L, B, S, Hkv, hd)
            b = _batch_entry(leaf.shape[1], axes, sizes)
            if heads_ok:
                return P(None, b, None, tp, None)
            return P(None, b, None, None, tp)  # shard hd instead
        spec = [None] * leaf.dim()
        spec[0] = _batch_entry(leaf.shape[0], axes, sizes)
        return P(*spec)

    return _map_with_path(visit, cache_tree)


def _is_spec(x):
    return isinstance(x, P)


def _is_placements(x):
    return isinstance(x, tuple) and not any(isinstance(e, (dict, list, tuple)) for e in x)


def _leaves_of(tree, is_leaf):
    """The leaves of a tree of specs or placements in leaf order (each is
    a tuple, not a subtree)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaves_of(tree[k], is_leaf)]
    return [s for v in tree for s in _leaves_of(v, is_leaf)]


def to_shardings(pspec_tree, mesh):
    """Each spec as the mesh-dim-wise ``DTensor`` placements."""
    if _is_spec(pspec_tree):
        return pspec_to_placements(pspec_tree, mesh)
    if isinstance(pspec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in pspec_tree.items()}
    return type(pspec_tree)(to_shardings(v, mesh) for v in pspec_tree)


def fix_divisibility(tree, pspec_tree, mesh):
    """Drop sharding axes that do not divide their dimension.

    A ``DTensor`` shards an uneven dim, but ``local_map`` rebuilds a
    block's outputs assuming even shards, and the reference's explicit
    pjit shardings must divide evenly too.  For awkward extents -- vocab
    256206, head_dim 120, batch 1 -- we keep the maximal prefix of each
    dim's axes that divides; the rest of the dim is replicated.
    """
    sizes = mesh_sizes(mesh)
    fixed = [fix_spec(s, a.shape, sizes)
             for a, s in zip(leaves(tree), _leaves_of(pspec_tree, _is_spec))]
    return unflatten(tree, fixed)


def shardings_for(tree, pspec_tree, mesh):
    """Divisibility-fixed placements for ``tree``."""
    return to_shardings(fix_divisibility(tree, pspec_tree, mesh), mesh)


def _with_paths(tree, path=()):
    """(path of dict keys, leaf) of ``tree`` in leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _with_paths(v, path + (i,))]
    return [(path, tree)]


def validate_pspecs(params_tree, pspec_tree, mesh):
    """Every sharded dim must divide by its mesh-axes product."""
    sizes = mesh_sizes(mesh)
    problems = []
    for (path, leaf), spec in zip(_with_paths(params_tree), _leaves_of(pspec_tree, _is_spec)):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= sizes[a]
            if leaf.shape[dim] % n != 0:
                problems.append(
                    f"{''.join(f'[{k!r}]' for k in path)}: dim {dim} "
                    f"({leaf.shape[dim]}) % mesh{axes}={n} != 0")
    return problems


def distribute(tree, pspec_tree, mesh):
    """A tree of tensors (the same on every rank) as ``DTensor``s placed by
    ``pspec_tree`` after ``fix_divisibility``; each rank keeps a copy of
    its shards, cut locally with no communication (a view would keep the
    whole tensor alive and see its in-place updates)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, pl):
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), mesh, pl, run_check=False,
                                  shape=d.shape, stride=d.stride())

    placements = _leaves_of(shardings_for(tree, pspec_tree, mesh), _is_placements)
    return unflatten(tree, [place(t, pl) for t, pl in zip(leaves(tree), placements)])

