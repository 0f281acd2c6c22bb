"""Parameter trees in the reference's pytree layout: nested dicts and
lists of tensors, where None is an empty subtree (no leaf), as in JAX.

The leaf order is JAX's: dict keys sorted, lists in order. A leaf's path
is JAX's `tree_flatten_with_path` keys joined by "/" (``params/cin/0``,
``opt/m/mlp/1/w``): the names under which a checkpoint stores it.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) in JAX's leaf order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from leaves_with_path(sub, f"{prefix}/{key}" if prefix else key)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def path_tree(tree, prefix: str = ""):
    """A tree of ``tree``'s structure whose leaves are their own paths."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: path_tree(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(path_tree(v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return prefix


def tree_unflatten(tree_like, leaves):
    """A tree of ``tree_like``'s structure holding ``leaves``, given in
    JAX's leaf order (the inverse of `tree_leaves`)."""
    by_path = dict(zip((p for p, _ in leaves_with_path(tree_like)), leaves))
    return tree_map(lambda path: by_path[path], path_tree(tree_like))
