"""Field-wise maps over dataclasses of tensors — the port's stand-in for
``jax.tree.map`` over the JAX package's registered pytrees."""

import dataclasses

import torch


def tree_map(fn, obj, *rest):
    """Apply fn to every tensor leaf of obj (and the matching leaves of
    rest). Dataclasses, dicts, tuples and lists recurse; None and plain
    Python values pass through unchanged."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, v, *[r[i] for r in rest])
                         for i, v in enumerate(obj))
    return obj


def tree_leaves(obj):
    """The tensor leaves of obj, in tree_map's order."""
    out = []
    tree_map(lambda x: out.append(x) or x, obj)
    return out


def tree_where(pred, a, b):
    """Per-lane select between two structures with [C, ...] leaves."""
    def sel(x, y):
        if x.ndim == 0:
            return x
        p = pred.reshape(pred.shape + (1,) * (x.ndim - pred.ndim))
        return torch.where(p, x, y)
    return tree_map(sel, a, b)


def tree_take(obj, idx):
    """Gather lanes idx from every [C, ...] leaf."""
    return tree_map(lambda x: x[idx] if x.ndim >= 1 else x, obj)


def select_by_type(tag, branches):
    """Per-lane select among the branches of a type dispatch: branches is
    a list of (type, structure) pairs, one for each type some lane may
    have; each lane takes the structure of its tag's type (the last pair
    for a tag that matches none)."""
    out = branches[-1][1]
    for t, b in reversed(branches[:-1]):
        m = tag == t

        def sel(x, y, m=m):
            return torch.where(m.reshape(m.shape + (1,) * (x.ndim - m.ndim)),
                               x, y)
        out = tree_map(sel, b, out)
    return out
