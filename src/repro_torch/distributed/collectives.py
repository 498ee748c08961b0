"""Collective helpers of the port — ``repro/distributed/collectives.py``:
bucketed gradient all-reduce with optional compression, over
``torch.distributed``.

The reference expresses them with ``shard_map`` + ``psum`` inside one
controller; here every rank calls them on its own tree, and an ``axis`` is
a process group, or a ``(mesh, axis name)`` pair whose group
``core.comm.axis_group`` finds.  Each bucket is one all-reduce of the
bucket's leaves packed flat (a dtype at a time), so early buckets can go on
the wire while later gradients are still being made; ``compress="bf16"``
halves the payload.
"""
from __future__ import annotations

from typing import Any, List

import torch

from ..core import comm


def _leaves(tree) -> List[Any]:
    """The tree's leaves in the reference's order (``jax.tree.leaves``:
    dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return next(it)


def _group(axis):
    if isinstance(axis, tuple):
        mesh, name = axis
        return comm.axis_group(mesh, (name,))
    return axis


def bucket_leaves(tree, bucket_bytes: int = 16 * 1024 * 1024) -> List[List[int]]:
    """Group leaf indices into ~bucket_bytes buckets (reduce units)."""
    buckets: List[List[int]] = [[]]
    size = 0
    for i, leaf in enumerate(_leaves(tree)):
        b = int(leaf.numel()) * leaf.element_size()
        if size + b > bucket_bytes and buckets[-1]:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += b
    return buckets


def psum_tree(tree, axis):
    """Every leaf summed over the ranks of ``axis``."""
    group = _group(axis)
    it = iter([comm.all_reduce(x, group) for x in _leaves(tree)])
    return _rebuild(tree, it)


def bucketed_psum(tree, axis, bucket_bytes: int = 16 * 1024 * 1024, compress: str = "none"):
    """The leaves summed over ``axis`` a bucket at a time; ``compress`` in
    {none, bf16}: bf16 puts half the bytes on the wire."""
    if compress not in ("none", "bf16"):
        raise ValueError(f"compress={compress!r}; valid: none, bf16")
    group = _group(axis)
    leaves = _leaves(tree)
    out: List[Any] = [None] * len(leaves)
    for idx in bucket_leaves(tree, bucket_bytes):
        by_wire: dict = {}
        for i in idx:
            wire = torch.bfloat16 if compress == "bf16" else leaves[i].dtype
            by_wire.setdefault(wire, []).append(i)
        for wire, ids in by_wire.items():
            flat = torch.cat([leaves[i].reshape(-1).to(wire) for i in ids])
            summed = comm.all_reduce(flat, group)
            off = 0
            for i in ids:
                n = leaves[i].numel()
                out[i] = summed[off:off + n].reshape(leaves[i].shape).to(leaves[i].dtype)
                off += n
    return _rebuild(tree, iter(out))


def cross_pod_mean(tree, mesh, compress: str = "bf16"):
    """The mean of a per-pod gradient tree across the ``pod`` axis (the
    explicit cross-pod reduction); the tree as it is on a mesh without
    one."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return tree
    n = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))["pod"]
    summed = bucketed_psum(tree, (mesh, "pod"), compress=compress)
    return _rebuild(tree, iter([x / n for x in _leaves(summed)]))
