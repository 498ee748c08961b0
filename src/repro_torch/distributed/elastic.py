"""Elastic scaling of the port — ``repro/distributed/elastic.py``: rebuild
the mesh from the surviving world and re-shard state onto it.

``choose_mesh_shape`` picks the largest (data, model) grid the surviving
ranks support, keeping the model-parallel degree where it can (TP degree is
a property of the weights' divisibility, DP degree is free to shrink or
grow).  ``make_elastic_mesh`` builds that grid as a ``DeviceMesh`` over the
first data x model ranks of the world.  ``reshard_state`` places full
(replicated or host) state onto the new mesh as DTensors under the rules'
placements (``params_shardings``, ``opt_state_shardings``); each rank cuts
its own shard of the full tensor it holds, with no communication
(``src_data_rank=None``), and ``full_tensor()`` gives the input back.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.device import resolve_device
from .sharding import Sharding, _walk, opt_state_shardings, params_shardings


def choose_mesh_shape(num_devices: int, prefer_model: int = 16) -> Tuple[int, int]:
    """(data, model) for the surviving device count."""
    if num_devices < 1:
        raise ValueError(
            f"choose_mesh_shape needs at least one device, got num_devices={num_devices}"
        )
    if prefer_model < 1:
        raise ValueError(
            f"prefer_model must be a positive model-parallel degree, got {prefer_model}"
        )
    model = min(prefer_model, num_devices)
    while num_devices % model:
        model -= 1
    return num_devices // model, model


def make_elastic_mesh(world=None, prefer_model: int = 16, device=None):
    """A (data, model) ``DeviceMesh`` over the first data x model ranks of a
    world of ``world`` ranks (default: the current world's size), on
    ``device``'s type (the card unless the caller asks for the CPU)."""
    if prefer_model < 1:
        choose_mesh_shape(1, prefer_model)     # raises naming prefer_model
    if world is None:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("make_elastic_mesh needs a torch.distributed world "
                               "(init_process_group) or num_devices=world")
        world = dist.get_world_size()
    data, model = choose_mesh_shape(int(world), prefer_model)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(resolve_device(device).type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def _place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor under its ``Sharding``."""
    from torch.distributed.tensor import distribute_tensor

    flat = []
    _walk(shardings, lambda path, s, st: flat.append(s))
    it = iter(flat)

    def one(path, t, st):
        s: Sharding = next(it)
        return distribute_tensor(t, s.mesh, list(s.placements), src_data_rank=None)

    return _walk(tree, one)


def reshard_state(params, opt_state, new_mesh):
    """Re-place full (host or replicated) state onto a new mesh: params
    under ``params_shardings``, AdamW's m and v mirroring them, its step
    replicated."""
    from ..train.optimizer import AdamWState

    pshard = params_shardings(params, new_mesh)
    new_params = _place(params, pshard)
    if opt_state is None:
        return new_params, None
    oshard = opt_state_shardings(opt_state, pshard, new_mesh)
    new_opt = AdamWState(
        step=_place(opt_state.step, oshard.step),
        m=_place(opt_state.m, oshard.m),
        v=_place(opt_state.v, oshard.v),
    )
    return new_params, new_opt
