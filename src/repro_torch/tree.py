"""Trees of tensors: nested dicts, lists and tuples (NamedTuples
included), the port's counterpart of ``jax.tree``'s ``map`` and
``leaves`` for the parameter, gradient, optimizer-state and cache trees."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf (anything not a dict, list or tuple),
    the containers rebuilt as they were; with ``rest``, trees of the same
    structure, ``fn(leaf, *their leaves)`` as ``jax.tree.map`` does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return vals
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order (dict keys sorted), None
    skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]
