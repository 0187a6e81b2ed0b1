"""Flatten nested tuples, lists and dicts of update arguments and states into
leaves and a hashable structure (what ``jax.tree_util`` does for the JAX
engine). ``None`` is a leaf here; everything that is not a tuple, list or
dict is a leaf."""
from typing import Any, Hashable, List, Tuple

_LEAF = "*"


def flatten(tree: Any) -> Tuple[List[Any], Hashable]:
    leaves: List[Any] = []

    def _walk(node: Any) -> Hashable:
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return ("t", tuple(_walk(x) for x in node))
        if isinstance(node, list):
            return ("l", tuple(_walk(x) for x in node))
        if isinstance(node, dict):
            keys = tuple(node)
            return ("d", keys, tuple(_walk(node[k]) for k in keys))
        leaves.append(node)
        return _LEAF

    return leaves, _walk(tree)


def unflatten(spec: Hashable, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def _build(s: Any) -> Any:
        if s == _LEAF:
            return next(it)
        if s[0] == "t":
            return tuple(_build(c) for c in s[1])
        if s[0] == "l":
            return [_build(c) for c in s[1]]
        return {k: _build(c) for k, c in zip(s[1], s[2])}

    return _build(spec)
