"""The few pytree operations the training modules need, on the port's
trees: nested dicts (and lists, tuples, NamedTuples such as
``optimizer.AdamWState``) with tensors or arrays at the leaves.

Leaves come in JAX's order — dict keys sorted, a NamedTuple's fields in
declaration order, sequences by index — and each leaf's path is the
tuple of its keys written as ``repro.train.checkpoint`` writes JAX's key
paths: a dict key or sequence index as itself, a NamedTuple field as
``.name``.  Checkpoint manifests and the optimizer's decay mask read
these paths, so both packages name every leaf alike.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Pytree = Any
Path = Tuple[str, ...]


def _children(node) -> List[Tuple[str, Any]]:
    """(path entry, child) pairs of an inner node in JAX's order, or
    [] for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple))


def flatten_with_path(tree: Pytree, path: Path = ()
                      ) -> List[Tuple[Path, Any]]:
    """Every leaf of ``tree`` with its path, in JAX's order."""
    if _is_leaf(tree):
        return [(path, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(flatten_with_path(child, path + (key,)))
    return out


def leaves(tree: Pytree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Pytree, new_leaves) -> Pytree:
    """A tree of ``like``'s structure whose leaves are ``new_leaves``
    (an iterable, in JAX's order)."""
    it: Iterator = iter(new_leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}        # keep key order
        kids = [build(c) for _, c in _children(node)]
        if hasattr(node, "_fields"):
            return type(node)(*kids)
        return type(node)(kids)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the
    same structure), leaf by leaf."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def path_str(path: Path) -> str:
    """A leaf's path as ``repro.train.checkpoint._path_str`` writes
    JAX's (``"o/.m/layers/a_log"``)."""
    return "/".join(path)
