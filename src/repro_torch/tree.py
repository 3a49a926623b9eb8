"""Trees of tensors (nested dicts and tuples), as the reference's
pytrees: :func:`tree_map`, and flattening in the order
``jax.tree_util.tree_flatten`` uses: dict keys sorted, tuples and lists by
index.  That order fixes the sum of :func:`repro_torch.optim.global_norm`
and the leaf keys of a checkpoint, which join the dict keys and sequence
indexes on a leaf's path with ``/`` (the reference's keys)."""
from __future__ import annotations

from typing import Any, Callable

Tree = Any
_END = object()


def _children(node) -> list:
    """(key, child) pairs of a dict / tuple / list node, in JAX's order."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def flatten_with_paths(tree: Tree) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs; the key joins the path's dict keys and
    sequence indexes with ``/``."""
    out: list[tuple[str, Any]] = []

    def walk(node, prefix: str) -> None:
        if not _is_node(node):
            out.append((prefix, node))
            return
        for k, child in _children(node):
            walk(child, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Tree, new_leaves) -> Tree:
    """A tree of ``like``'s structure whose leaves, in flattening order,
    are ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of one structure); dicts keep their key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def structure(tree: Tree) -> str:
    """The tree's shape as a string, ``*`` for a leaf: ``{'a': *, 'b':
    (*, *)}``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(structure(c) for c in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(c) for c in tree) + "]"
    return "*"
