"""Nested parameter trees (dicts, lists and tuples of tensors), walked in
the order JAX flattens a pytree: dict keys sorted at every level, lists
and tuples by index.  The optimiser, the gradient utilities and the
checkpoint use it, so that sums over leaves run in the reference's order
and leaf names equal the reference's."""

from __future__ import annotations


def leaves_with_paths(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in JAX's flattening order; a path is a tuple of dict
    keys (as strings) and sequence indices.  None is an empty subtree, as
    in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(leaves_with_paths(tree[key], path + (str(key),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, value in enumerate(tree):
            out.extend(leaves_with_paths(value, path + (str(i),)))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values) -> object:
    """A tree shaped like ``like`` whose leaves are ``values``, in
    :func:`leaves_with_paths` order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same shape)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
