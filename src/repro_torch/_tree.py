"""Minimal pytree helpers over nested dicts, lists and tuples.

The port keeps the JAX package's parameter and cache trees (dicts of
leaves, lists over segments and period positions) so that the two
packages can be compared leaf by leaf; these helpers stand in for
``jax.tree.map`` / ``jax.tree.leaves``.  Dict keys are visited in sorted
order, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Map ``fn`` over the leaves of ``tree`` and structurally aligned
    ``rest`` trees; ``is_leaf`` stops the descent at matching nodes."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest],
                            is_leaf=is_leaf) for k in sorted(tree)}
    out = [tree_map(fn, t, *[r[i] for r in rest], is_leaf=is_leaf)
           for i, t in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def tree_map_with_path(fn: Callable, tree, path: Tuple[Any, ...] = ()):
    """``fn(path, leaf)`` where ``path`` is the tuple of dict keys and list
    indices from the root."""
    if not _is_node(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    out = [tree_map_with_path(fn, t, path + (i,)) for i, t in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out
