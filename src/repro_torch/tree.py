"""Parameter trees: nested dicts and lists of tensors, as the port keeps
them, walked in the order ``jax.tree_util`` walks the same structure
(dict keys sorted, list items in order).  Anything else is a leaf, a tuple
or ``None`` included, as ``core/pipeline.map_leaves`` treats them.

``value_and_grad`` is the counterpart of ``jax.value_and_grad`` over such
a tree, through ``torch.autograd``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in ``flatten``'s
    order); dicts keep ``like``'s key order."""
    it = iter(leaves)
    end = object()

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out


def value_and_grad(fn: Callable, params, *args):
    """(fn(params, *args), d fn / d params) for a scalar ``fn``: the
    gradient is a tree like ``params``, each leaf in its parameter's dtype
    (zeros where ``fn`` does not read the leaf, as JAX gives).  ``params``
    are not modified; the value is detached."""
    leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
    with torch.enable_grad():
        value = fn(unflatten(params, leaves), *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                    materialize_grads=True)
    return value.detach(), unflatten(params, list(grads))
