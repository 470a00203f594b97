"""Parameter trees of the port: nested dicts, lists and tuples (named tuples
too) of tensors, walked in a fixed order — the counterpart of ``jax.tree``
for the optimizer, the checkpointer and the train step.

Dict keys are visited in sorted order, as ``jax.tree`` visits them, so a
tree's leaf order does not depend on how its dicts were built.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["LEAF", "flatten", "flatten_with_path", "unflatten", "leaves",
           "paths", "tree_map", "tree_map_with_path"]


class _Leaf:
    """The placeholder of a leaf in a tree's structure."""

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, path: tuple, is_leaf, out: list):
    """The structure of ``node`` with each leaf replaced by :data:`LEAF`;
    appends ``(path, leaf)`` to ``out`` in the walk's order."""
    if is_leaf is not None and is_leaf(node):
        out.append((path, node))
        return LEAF
    if isinstance(node, dict):
        return {k: _walk(node[k], path + (k,), is_leaf, out)
                for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*[_walk(c, path + (f,), is_leaf, out)
                            for f, c in zip(node._fields, node)])
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(c, path + (i,), is_leaf, out)
                          for i, c in enumerate(node))
    out.append((path, node))
    return LEAF


def flatten(tree: Any, is_leaf: Callable[[Any], bool] | None = None
            ) -> tuple[list, Any]:
    """``(leaves, structure)``: the leaves in order and the tree with each
    leaf replaced by :data:`LEAF`. ``is_leaf(node)`` true stops the walk at
    ``node`` (e.g. a quantized moment kept whole)."""
    out: list = []
    structure = _walk(tree, (), is_leaf, out)
    return [leaf for _, leaf in out], structure


def flatten_with_path(tree: Any,
                      is_leaf: Callable[[Any], bool] | None = None
                      ) -> tuple[list[tuple[tuple, Any]], Any]:
    """``([(path, leaf), ...], structure)``: :func:`flatten` with each
    leaf's path from the root, a tuple of dict keys, named-tuple field
    names and sequence indices."""
    out: list = []
    structure = _walk(tree, (), is_leaf, out)
    return out, structure


def paths(tree: Any, is_leaf: Callable[[Any], bool] | None = None
          ) -> list[str]:
    """Each leaf's path from the root, keys and indices joined by dots
    (``"layers.3.attn.wk"``), in :func:`flatten`'s order."""
    return [".".join(str(k) for k in path)
            for path, _ in flatten_with_path(tree, is_leaf)[0]]


def unflatten(structure: Any, items) -> Any:
    """The tree of ``structure`` with its leaves taken from ``items`` in
    order; every item must be used."""
    it = iter(items)

    def build(node):
        if node is LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*[build(c) for c in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return node

    tree = build(structure)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure holds")
    return tree


def leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf by leaf, of ``rest``
    (trees of the same structure); the result has ``tree``'s structure."""
    flat, structure = flatten(tree, is_leaf)
    others = [flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees of {len(flat)} and {len(o)} leaves")
    return unflatten(structure, [fn(*xs) for xs in zip(flat, *others)])


def tree_map_with_path(fn: Callable, tree: Any,
                       is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree`` (paths as in
    :func:`flatten_with_path`); the result has ``tree``'s structure."""
    items, structure = flatten_with_path(tree, is_leaf)
    return unflatten(structure, [fn(path, leaf) for path, leaf in items])
