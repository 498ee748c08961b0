"""The sharded train step: the reference's ``jax.jit(step, in_shardings=(pshard,
oshard, None), out_shardings=(pshard, oshard, None), donate_argnums=(0,
1))`` behind ``launch/train.py --mesh``, as explicit SPMD over
``core/comm.py``.

At rest every rank holds its blocks: params, AdamW's m and v as
``DTensor``s placed by ``params_shardings`` / ``opt_state_shardings``
(ZeRO-style over the fsdp axes, a second dim over ``model``), the step
count replicated; ``distributed.reshard_state`` places full state so.  A
step, on every rank:

  1. gathers each param whole over the axes its placement names
     (``shard.assemble``: one all-gather a sharded dim, through
     ``core.comm``, which picks the backend's form);
  2. cuts each microbatch's rows over the data axes (``batch_axes``) and
     again over ``model`` where they divide (``row_axes``), so no two ranks
     compute the same rows, and runs the port's loss and gradient code
     (``make_loss_sums_fn``, ``value_and_grad``) on its rows with the
     whole params;
  3. divides its NLL sum by the count of valid labels over every rank's
     rows (an all-reduce of the counts: labels of -1 make the ranks' counts
     unequal, so the global loss is not the mean of the ranks' means);
  4. sums the gradients over the ranks that hold different rows
     (``bucketed_psum``), so every rank holds the whole gradient, takes the
     clip norm from it (each element counted once) and cuts its blocks;
  5. runs AdamW in place on its blocks (``adamw_update_``).

GSPMD partitions the reference's compute otherwise (Megatron products
over ``model``, the sequence-parallel stash); the numbers are the same.
The step writes the blocks in place and returns the same trees, as the
unsharded ``make_train_step`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..core import comm
from ..core.shard import assemble, block_cuts, dtensor_layout, local_block, spec_to_layout
from ..distributed.collectives import bucketed_psum
from ..distributed.sharding import axis_size, axis_sizes, batch_axes
from ..models.module import tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_update_, global_norm
from .trainer import F32, _device_batch, make_loss_sums_fn, value_and_grad


def row_axes(mesh, rows: int) -> Tuple[str, ...]:
    """The mesh axes a (micro)batch of ``rows`` rows is cut over: the data
    axes that divide it (``batch_axes``), then ``model`` where the rows
    still divide."""
    axes = list(batch_axes(mesh, rows))
    n = axis_size(mesh, tuple(axes)) if axes else 1
    if "model" in axis_sizes(mesh) and rows % (n * axis_size(mesh, "model")) == 0:
        axes.append("model")
    return tuple(axes)


def rank_rows(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of each entry of ``batch``: its block on dim 0 over
    the ``row_axes`` of the batch's rows."""
    axes = row_axes(mesh, next(iter(batch.values())).shape[0])
    return {k: local_block(v, block_cuts(spec_to_layout((axes or None,), v.ndim), mesh))
            for k, v in batch.items()}


def _locals(tree):
    return tree_map(lambda t: t.to_local(), tree)


def make_sharded_train_step(cfg, opt_cfg: AdamWConfig, mesh, accum_steps: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics) on
    ``mesh`` (the module docstring).  ``params`` and the state's m and v
    are ``DTensor`` trees on ``mesh``, written in place; ``batch`` is the
    global batch (numpy arrays or tensors), the same on every rank.  The
    metrics (loss, grad_norm, lr) are the global ones, on every rank."""
    sums_fn = make_loss_sums_fn(cfg)

    def micro_grads(full, mb):
        """This rank's share of one microbatch: (its term of the global
        loss, its gradients)."""
        axes = row_axes(mesh, mb["tokens"].shape[0])
        group = comm.axis_group(mesh, axes) if axes else None
        mine = rank_rows(mb, mesh)
        count = (mine["labels"] >= 0).sum().to(F32)
        if group is not None:
            count = comm.all_reduce(count, group)
        denom = torch.clamp(count, min=1.0)

        def loss_fn(tree, b):
            return sums_fn(tree, b)[0] / denom

        return value_and_grad(loss_fn, full, mine), group

    @torch.no_grad()
    def train_step(params, opt_state: AdamWState, batch):
        blocks = _locals(params)
        dev = blocks["embed"]["tok"].device
        batch = _device_batch(batch, dev)
        with comm.mesh_scope(mesh):
            full = tree_map(lambda p: assemble(p.to_local(), dtensor_layout(p), mesh), params)
            if accum_steps == 1:
                (loss, grads), group = micro_grads(full, batch)
            else:
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=dev), full)
                loss = torch.zeros((), dtype=F32, device=dev)
                for i in range(accum_steps):
                    mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])[i]
                          for k, v in batch.items()}
                    (lval, g), group = micro_grads(full, mb)
                    tree_map(lambda a, b: a.add_(b.to(F32)), grads, g)
                    loss = loss + lval
                    del g
            del full
            if group is not None:
                grads = bucketed_psum(grads, group)
                loss = comm.all_reduce(loss, group)
            if accum_steps > 1:
                tree_map(lambda g: g.div_(accum_steps), grads)
                loss = loss / accum_steps
            norm = global_norm(grads)
            gblocks = tree_map(lambda g, p: local_block(g, block_cuts(dtensor_layout(p), mesh)),
                               grads, params)
            del grads
            state = AdamWState(opt_state.step.to_local(), _locals(opt_state.m),
                               _locals(opt_state.v))
            _, _, om = adamw_update_(opt_cfg, blocks, gblocks, state, norm=norm)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def gather_tree(tree) -> Dict:
    """Every ``DTensor`` leaf of ``tree`` as its global value, on every rank
    (``shard.gather_dtensor``); a collective of the whole mesh."""
    from ..core.shard import gather_dtensor

    return tree_map(gather_dtensor, tree)
