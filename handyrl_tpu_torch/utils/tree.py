"""Pytree helpers for the host-side (numpy) data path.

Two families live here:

  * ``tree_map`` / ``tree_stack`` walk nested observation structures
    with ``None`` treated as a LEAF (passed to ``fn``): episode moments
    use ``None`` to mean "player did not act/observe at this step", and
    it must survive the traversal;
  * ``tree_flatten`` / ``tree_leaves`` / ``tree_structure`` /
    ``tree_unflatten`` / ``tree_map_leaves`` follow ``jax.tree_util``'s
    rules exactly: dict keys in sorted order, lists and tuples in
    order, ``None`` a node with no leaves.  The shm request schema is a
    flat leaf list in this order, so a worker of either package and a
    service of either package agree on which bytes are which leaf.
"""

import numpy as np


def tree_map(fn, x):
    """Map ``fn`` over leaves of a nested list/tuple/dict structure,
    ``None`` included as a leaf."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return fn(x)


def tree_stack(trees, axis=0):
    """Stack a list of identically-structured trees leaf-wise."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees], axis) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            tree_stack([t[i] for t in trees], axis) for i in range(len(first))
        )
    return np.stack([np.asarray(t) for t in trees], axis=axis)


def stack_time_player(moment_rows, template):
    """Build ``(T, P, ...)`` leaf arrays from a ``[T][P]`` nested list of
    observation trees, zero-filling ``None`` entries from ``template``."""
    def fill(entry):
        return template if entry is None else entry

    return tree_stack(
        [tree_stack([fill(p) for p in row]) for row in moment_rows])


# -- jax.tree_util-compatible flattening ---------------------------------
#
# A treedef is a hashable nested tuple, so two structures compare with
# ``==`` as jax treedefs do:  _LEAF | None | ("dict", keys, children) |
# ("list", children) | ("tuple", children).

_LEAF = "*"


def tree_flatten(tree):
    """``(leaves, treedef)`` in jax's leaf order."""
    leaves = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, list):
            return ("list", tuple(walk(v) for v in x))
        if isinstance(x, tuple):
            return ("tuple", tuple(walk(v) for v in x))
        leaves.append(x)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_structure(tree):
    return tree_flatten(tree)[1]


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == _LEAF:
            return next(it)
        kind = node[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        children = [build(c) for c in node[1]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    rest = list(it)
    if rest:
        raise ValueError(
            f"tree_unflatten: {len(rest)} leaves left over for the treedef")
    return out


def tree_map_leaves(fn, tree):
    """``jax.tree.map`` semantics: ``fn`` over the leaves, ``None``
    nodes kept as ``None`` and never passed to ``fn``."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


# -- parameter trees ------------------------------------------------------

def flatten_params(params, prefix=""):
    """Nested param dict -> flat ``{"a/b/kernel": array}`` mapping
    (the on-disk .npz export convention of the JAX package)."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat):
    """Inverse of :func:`flatten_params`."""
    params = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return params


def softmax_np(x, axis=-1):
    """Numerically-stable softmax on numpy arrays (actor-side sampling)."""
    x = np.asarray(x, dtype=np.float32)
    z = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return z / z.sum(axis=axis, keepdims=True)
