"""Trees of tensors: nested dicts and lists -- the port's params, grads
and optimizer state, where the JAX package has pytrees.

Leaves come in ``jax.tree_util``'s order for such trees (dict keys sorted,
lists in order), so a tree of dicts flattens as the reference's does and a
checkpoint's leaf ``i`` is the same leaf in both packages.
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like, flat):
    """A tree with ``like``'s structure holding the leaves ``flat`` in
    leaf order."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            done = {k: fill(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return next(it)

    out = fill(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out


def structure(tree) -> str:
    """The structure as ``jax.tree_util``'s ``PyTreeDef`` prints it, leaves
    as ``*`` (equal to the reference's for a tree of dicts)."""
    if isinstance(tree, dict):
        items = ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree))
        return "{" + items + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(structure(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"
