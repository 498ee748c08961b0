"""Mesh construction of the port — ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``DeviceMesh`` over the current
``torch.distributed`` world, on the card unless the caller asks for the
CPU (``device="cpu"``).
"""
from __future__ import annotations

from ..core.device import resolve_device


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh {names} needs a world of {need} ranks; "
            f"the current world has {world or 'none'}"
        )
    return init_device_mesh(resolve_device(device).type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks a pod single-pod, or 2x16x16 = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_smoke_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the whole current world (data x model
    ranks)."""
    return _mesh((data, model), ("data", "model"), device)
