"""Nested dicts of tensors, the port's counterpart of a JAX pytree of
parameters: leaves with their paths, maps over trees of one structure,
and a tree rebuilt from leaves by path.  Keys are walked in sorted
order, as ``jax.tree`` walks a dict, so a tree's leaves come in the
reference's order."""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def leaves_with_paths(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, paths as ``/key/subkey``."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree)
                for leaf in leaves_with_paths(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def tree_map(fn: Callable, *trees):
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def unflatten(template, leaves: Mapping[str, Any], path: str = ""):
    """A tree of ``template``'s structure whose leaves are
    ``leaves[path]``."""
    if isinstance(template, Mapping):
        return {k: unflatten(template[k], leaves, f"{path}/{k}")
                for k in template}
    return leaves[path]


__all__ = ["leaves_with_paths", "tree_map", "unflatten"]
