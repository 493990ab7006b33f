"""Trees of tensors, the port's stand-in for ``jax.tree``: nested dicts,
lists and tuples whose leaves are tensors (the LM's params and decode
caches, the optimizer's state).  Dict keys are visited in sorted order, as
``jax.tree`` visits them, so a sum over the leaves adds them in the
reference's order; ``tree_map`` keeps each dict's own key order.  None is
a subtree with no leaves, as in ``jax.tree`` (a whisper encoder group's
decode cache).  ``is_leaf`` stops the descent where it returns True, as
``jax.tree``'s does: the logical-axis spec trees (``models/lm.py``
``param_specs``) hold tuples of axis names as leaves."""
from __future__ import annotations


def tree_map(fn, *trees, is_leaf=None):
    """``fn`` over the leaves of ``trees`` (one structure, read from the
    first), as ``jax.tree.map``."""
    t0 = trees[0]
    if is_leaf is not None and is_leaf(t0):
        return fn(*trees)
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs, is_leaf=is_leaf)
                        for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for k in sorted(tree)
                for a in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in tree_leaves(t, is_leaf)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)
