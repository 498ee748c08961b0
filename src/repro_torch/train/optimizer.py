"""AdamW + LR schedules, the reference's ``repro/train/optimizer.py`` in
torch.

The optimizer state mirrors the params (m, v in f32).  ``step`` is a 0-d
int32 tensor on the params' device, and the LR schedule and the bias
corrections are computed from it on the device, never from a Python int:
a train step captured once into a CUDA graph reads the current step on
every replay.

``adamw_update`` is the reference's function (new trees out, the inputs
untouched); ``adamw_update_`` writes the same arithmetic in place into the
params and the state, leaf by leaf (the train steps' form: donated
buffers).  Both clip inside the per-leaf update, so no f32 copy of every
gradient is held at once; a leaf's clipped gradient is the reference's
``g.astype(f32) * scale`` all the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.module import tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, on the params' device
    m: Any                   # f32 tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_ratio: float = 0.1


def tree_leaves_sorted(tree) -> List[Any]:
    """The leaves of nested dicts, keys sorted at every level: the order of
    ``jax.tree.leaves``, which the global norm's sum follows."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves_sorted(tree[k])]
    return [tree]


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), an f32 0-d
    tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac)
        )
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(F32))) for leaf in tree_leaves_sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, tree), norm


def _decay_mask(path: Tuple, leaf) -> bool:
    """No weight decay on norms/biases/scalars (1-D and smaller)."""
    return getattr(leaf, "ndim", 0) >= 2


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves_sorted(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def adamw_init_specs(param_specs) -> AdamWState:
    """The state's shapes and dtypes on the ``meta`` device, for dry runs."""
    def spec(p):
        return torch.empty(p.shape, dtype=F32, device="meta")

    return AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(spec, param_specs),
        v=tree_map(spec, param_specs),
    )


def _update_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c) -> torch.Tensor:
    """One leaf's update: ``m`` and ``v`` in place, the new parameter
    returned, rounded to ``p``'s dtype.  The reference's ``upd`` operation
    for operation, each rounded to f32 as there (``x.mul_(a)`` is ``a *
    x``; ``add_`` takes a product made apart, never a fused one)."""
    g = g.to(F32) * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.mul_(g).mul_(1 - cfg.b2))
    del g
    delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    if _decay_mask((), p):
        delta.add_(p.to(F32) * cfg.weight_decay)
    return (p.to(F32) - delta.mul_(lr)).to(p.dtype)


def _update(cfg: AdamWConfig, params, grads, state: AdamWState, inplace: bool, norm=None):
    gnorm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gnorm, cfg.grad_clip_norm)
    lr = lr_at(cfg, state.step)
    stepf = (state.step + 1).to(F32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    if not inplace:
        state = AdamWState(state.step, tree_map(torch.clone, state.m),
                           tree_map(torch.clone, state.v))

    def upd(p, g, m, v):
        new = _update_leaf(cfg, p, g, m, v, scale, lr, b1c, b2c)
        return p.copy_(new) if inplace else new

    new_params = tree_map(upd, params, grads, state.m, state.v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if inplace:
        state.step.add_(1)
        return params, state, metrics
    return new_params, AdamWState(state.step + 1, state.m, state.v), metrics


def adamw_update_(cfg: AdamWConfig, params, grads, state: AdamWState, norm=None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """The AdamW step in place: ``params``, ``state.m``, ``state.v`` and
    ``state.step`` are written and returned.  No host sync: the schedule,
    the bias corrections and the clip scale stay on the device.  ``norm``,
    when given, is the gradients' global norm (a sharded step passes the
    whole gradient's while ``grads`` holds its blocks)."""
    return _update(cfg, params, grads, state, inplace=True, norm=norm)


def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """The reference's ``adamw_update``: new params and state, the inputs
    left as they are."""
    return _update(cfg, params, grads, state, inplace=False)
