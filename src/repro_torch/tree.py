"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
stand-in for ``jax.tree``).

``repro`` keeps a model's parameters as a pytree; the port keeps the same
nesting (``repro_torch.models.transformer.init_lm``), so a leaf's path
names the same parameter in both packages.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_items"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure; the result
    has that structure (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if len(r) != len(tree):
                raise ValueError(f"tree_map: {len(r)} != {len(tree)} items")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """``(path, leaf)`` pairs in order, the path's keys joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in tree_items(v, f"{prefix}/{k}" if prefix else str(k))]
