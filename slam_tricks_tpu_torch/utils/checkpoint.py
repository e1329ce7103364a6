"""Solver-state checkpointing (port of ``slam_tricks_tpu/utils/checkpoint.py``;
SURVEY §5 "Checkpoint / resume": greenfield — the reference has no
training-checkpoint concept). Saves any nest of tensors (BAState,
SolveResult, params) to a single .npz with structure metadata, so a long
optimization can resume mid-run (params, lambda, iteration counter all
round-trip).

The leaves go in ``jax.tree_util``'s order, so that a file of either package
holds its leaves in the same order: NamedTuples by field, dicts by sorted key
(an OrderedDict in its own order), lists and tuples in order; None is no
leaf; anything else (a tensor, a number, an array) is one. The file is the
JAX package's format: ``leaf_{i}`` arrays and a ``__treedef__`` string,
here the port's own description of the structure
(``interop.checkpoint_from_jax`` reads a file the JAX package wrote).
"""

import collections
import json

import numpy as np
import torch


def _keys(d):
    """A dict's keys in leaf order."""
    return list(d) if isinstance(d, collections.OrderedDict) else sorted(d)


def _children(x):
    """(children in leaf order, rebuild(children)) of a container node, or
    None for a leaf or None."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(x), lambda c: type(x)(*c)
    if isinstance(x, (tuple, list)):
        return list(x), lambda c: type(x)(c)
    if isinstance(x, dict):
        keys = _keys(x)
        return [x[k] for k in keys], lambda c: type(x)(zip(keys, c))
    return None


def tree_leaves(tree):
    """The leaves of `tree` in ``jax.tree_util.tree_leaves``' order."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[0] for leaf in tree_leaves(child)]


def treedef(tree):
    """A string that names the structure of `tree`: its containers' types,
    NamedTuple fields and dict keys, '*' for each leaf."""
    if tree is None:
        return "None"
    node = _children(tree)
    if node is None:
        return "*"
    kids = [treedef(c) for c in node[0]]
    if hasattr(tree, "_fields"):
        kids = [f"{f}={k}" for f, k in zip(tree._fields, kids)]
    elif isinstance(tree, dict):
        kids = [f"{k!r}: {d}" for k, d in zip(_keys(tree), kids)]
    return f"{type(tree).__name__}({', '.join(kids)})"


def tree_unflatten(like, leaves):
    """A nest of `like`'s structure holding `leaves` in leaf order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        node = _children(x)
        if node is None:
            return next(it)
        return node[1]([build(c) for c in node[0]])

    return build(like)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path, tree):
    """Serialize a nest of tensors / numbers to `path` (.npz)."""
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(tree_leaves(tree))}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(treedef(tree)).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def read_leaves(data, like, device=None):
    """The leaves stored in the opened .npz `data` as a nest of `like`'s
    structure, each checked against `like`'s leaf count and shapes and
    loaded as its `like` leaf: a tensor to its dtype, on `device` (None:
    the `like` leaf's device), a Python number to its type, any other leaf
    to a numpy array of its dtype."""
    leaves_like = tree_leaves(like)
    n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
    if n_stored != len(leaves_like):
        raise ValueError(f"checkpoint has {n_stored} leaves, "
                         f"target expects {len(leaves_like)}")
    leaves = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        ref_shape = getattr(ref, "shape", None)
        if ref_shape is not None and tuple(arr.shape) != tuple(ref_shape):
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                             f"target {tuple(ref_shape)}")
        if isinstance(ref, torch.Tensor):
            leaves.append(torch.as_tensor(
                arr, dtype=ref.dtype,
                device=ref.device if device is None else device))
        elif isinstance(ref, (bool, int, float, complex)):
            leaves.append(type(ref)(arr.item()))
        else:
            leaves.append(np.asarray(arr, dtype=getattr(ref, "dtype", None)))
    return tree_unflatten(like, leaves)


def load_pytree(path, like):
    """Load tensors saved by `save_pytree`, restoring the structure of
    `like` (the target nest gives structure, dtypes and devices; see
    ``read_leaves``).

    The stored structure and leaf count are validated against `like`;
    loading into a mismatched structure raises instead of silently
    mis-assigning leaves."""
    with np.load(path) as data:
        stored_def = json.loads(bytes(data["__treedef__"]).decode())
        if stored_def != treedef(like):
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  stored: {stored_def}\n  target: {treedef(like)}")
        return read_leaves(data, like)
