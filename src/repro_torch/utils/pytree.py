"""Pytree utilities over nested dicts (and lists/tuples) of tensors.

Parameters in the port are nested dicts of ``torch.Tensor`` with the JAX
package's key names.  Leaf order follows ``jax.tree.leaves``: dict keys
sorted, sequences in order.  Flat vectors, codec payloads and the wire
manifest therefore line up with the JAX package's element for element.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


def safe_weight_sum(wf: torch.Tensor) -> torch.Tensor:
    """Denominator for weighted means: an all-zero weight vector (every
    sampled client reported zero examples) must yield a zero average, not
    NaNs that poison the global params.  Stays on the weights' device, so
    no host sync."""
    wsum = wf.sum()
    return torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)


def tree_leaves(tree: PyTree) -> list:
    """Leaves in JAX order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_leaves_with_path(tree: PyTree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order, each path spelled as
    ``jax.tree_util.keystr`` spells it: ``['head']['w1']``, ``[0]``."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, sub in enumerate(tree) for pl in tree_leaves_with_path(sub, f"{path}[{i}]")]
    return [(path, tree)]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """Rebuild ``like``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of one structure (the first's)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_where(mask: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Select a (mask true) or b leafwise; mask is a broadcastable bool
    tensor."""
    return tree_map(lambda x, y: torch.where(mask, x, y), a, b)


def tree_sq_norm(tree: PyTree) -> torch.Tensor:
    return sum(
        torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)
    )


def tree_size(tree: PyTree) -> int:
    """Total number of scalar elements."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def tree_bytes(tree: PyTree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_flatten_to_vector(tree: PyTree) -> torch.Tensor:
    """Concatenate every leaf (flattened, fp32) into one 1-D vector."""
    return torch.cat([x.to(torch.float32).reshape(-1) for x in tree_leaves(tree)])


def tree_unflatten_from_vector(vec: torch.Tensor, like: PyTree) -> PyTree:
    """Inverse of :func:`tree_flatten_to_vector` against a template pytree."""
    out, off = [], 0
    for leaf in tree_leaves(like):
        n = math.prod(leaf.shape)
        out.append(vec[off : off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_unflatten(like, out)


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (copied: numpy buffers from
    ``np.frombuffer`` are read-only).  ``bfloat16`` arrives from JAX as
    ``ml_dtypes.bfloat16``, which torch cannot read, so it crosses as its
    16-bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)
