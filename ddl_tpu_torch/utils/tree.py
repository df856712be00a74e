"""Nested dicts and lists of tensors (parameter trees) without JAX.

The LM's parameters are the JAX package's nested tree
``{"embed", "blocks": [{...}, ...], "lnf_g", "lnf_b", "head"}``. Three
operations cover what the port needs:

- :func:`leaves` in ``jax.tree.leaves`` order: dict keys sorted, lists in
  index order (``blocks`` before ``embed`` before ``head`` before ``lnf_b``
  before ``lnf_g``). The JAX package's flat ZeRO-1 plans
  (``ravel_pytree``) use this order, so a flat vector built here lines up
  with theirs element for element.
- :func:`map` over one or more trees of the same structure, keeping the
  first tree's dict key order.
- :func:`unflatten`, the inverse of :func:`leaves`.

Anything that is not a dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001 - tree.map, as jax.tree.map
    """``fn`` applied leafwise over trees of one structure; dict key order
    follows ``tree``."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree structures differ: keys {sorted(tree)} vs {r!r:.80}")
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree structures differ: {len(tree)} items vs {r!r:.80}")
        out = [map(fn, *items) for items in zip(tree, *rest)]
        return out if isinstance(tree, list) else tuple(out)
    for r in rest:
        if _is_node(r):
            raise ValueError("tree structures differ: a leaf against a node")
    return fn(tree, *rest)


def unflatten(like: Any, flat: Iterable) -> Any:
    """A tree shaped like ``like`` whose leaves, in :func:`leaves` order,
    are ``flat``."""
    flat = list(flat)
    if len(flat) != len(leaves(like)):
        raise ValueError(f"{len(flat)} leaves for a tree of {len(leaves(like))}")
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            made = {k: build(node[k]) for k in sorted(node)}
            return {k: made[k] for k in node}  # like's key order
        if isinstance(node, (list, tuple)):
            out = [build(sub) for sub in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(like)
