"""Nested dicts, lists and tuples of tensors (the port's parameter trees).

The reference walks its trees with ``jax.tree_util``; these helpers walk
the port's in the same leaf order (dict keys sorted, sequences in order),
so a sum over leaves adds them in the reference's order and a leaf's path
names it as the reference's checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order; a path holds
    the dict keys and sequence indices from the root to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` (in ``leaves``
    order); dicts keep ``like``'s key order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return tree


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
