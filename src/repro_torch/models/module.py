"""Minimal functional module system: params are nested dicts of tensors,
built by a single structure-walker that either materializes them
(``init_params``) or yields tensors on the ``meta`` device
(``param_specs``), which hold shapes and dtypes and no memory.

The tree is the reference's, key for key, with every layer's params
stacked on axis 0, so ``params_from_reference`` carries the reference's
weights across leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

Params = Dict[str, Any]


class Creator:
    """Walks the parameter structure.  ``materialize=False`` yields tensors
    on the ``meta`` device (shapes and dtypes only); True yields
    initialized tensors on ``device``, drawn from ``generator``."""

    def __init__(self, generator: Optional[torch.Generator], dtype: torch.dtype,
                 materialize: bool, device=None):
        self._gen = generator
        self.dtype = dtype
        self.materialize = materialize
        self.device = torch.device(device) if materialize else torch.device("meta")

    def _normal(self, shape, std: float):
        r = torch.randn(tuple(shape), generator=self._gen, dtype=torch.float32,
                        device=self.device)
        return r.mul_(std)

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 0.02, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype if dtype is not None else self.dtype
        shape = tuple(shape)
        if not self.materialize:
            return torch.empty(shape, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            return self._normal(shape, scale).to(dtype)
        if init == "fan_in":
            fan = shape[0] if len(shape) >= 2 else 1
            return self._normal(shape, fan ** -0.5).to(dtype)
        if init == "uniform_scalar":
            return torch.full(shape, scale, dtype=dtype, device=self.device)
        raise ValueError(init)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (several trees of one
    structure walk together)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def stack_layers(layer_fn: Callable[[Creator], Params], creator: Creator,
                 num_layers: int) -> Params:
    """Build ``num_layers`` copies of a layer's params stacked on axis 0,
    the layout the layer loop indexes.  Each layer is drawn and written
    into the stacked tensor in turn, so building holds one layer beside
    the stack."""
    one = layer_fn(creator)
    if not creator.materialize:
        return tree_map(lambda t: torch.empty((num_layers,) + tuple(t.shape),
                                              dtype=t.dtype, device="meta"), one)
    stacked = tree_map(lambda t: torch.empty((num_layers,) + tuple(t.shape),
                                             dtype=t.dtype, device=t.device), one)
    for i in range(num_layers):
        layer = one if i == 0 else layer_fn(creator)
        tree_map(lambda s, t: s[i].copy_(t), stacked, layer)
    return stacked


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree: views, so a write reaches the stack."""
    return tree_map(lambda t: t[i], stacked)


def count_params(tree) -> int:
    return int(sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree)
                   if hasattr(leaf, "shape")))


def tree_bytes(tree) -> int:
    return int(sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                   for leaf in tree_leaves(tree) if hasattr(leaf, "shape")))


def _from_reference(a, device: torch.device) -> torch.Tensor:
    """One leaf of the reference's tree as a tensor.  bfloat16 arrives as an
    ml_dtypes array, which the port does not import: it is recognised by
    its dtype's name and carried through float32, which holds every
    bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a copy: jax's arrays are read-only


def params_from_reference(tree, device=None) -> Params:
    """The port's parameter tree from the reference's (numpy arrays, or
    anything ``np.asarray`` reads), key for key, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _from_reference(a, dev), tree)


def opt_state_from_reference(state, device=None):
    """The port's ``AdamWState`` from the reference's (its step, m and v as
    numpy arrays, or anything ``np.asarray`` reads), leaf for leaf, on
    ``device`` (the card unless the caller asks for the CPU)."""
    from ..train.optimizer import AdamWState

    dev = resolve_device(device)
    step, m, v = state
    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        tree_map(lambda a: _from_reference(a, dev), m),
        tree_map(lambda a: _from_reference(a, dev), v),
    )
