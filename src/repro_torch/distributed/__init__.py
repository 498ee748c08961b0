"""The port's distribution layer — ``repro/distributed``: the sharding rules
(``sharding``), collective helpers (``collectives``) and elastic re-meshing
(``elastic``), over ``torch.distributed`` and ``DeviceMesh``.

``__all__`` holds the reference package's names; ``wrap_shard_map``
is the port's eager SPMD form of ``shard_map`` (``core.shard``).  Then the
port's own: ``MeshShape``, ``Sharding``, ``axis_sizes``.
"""
from ..core.shard import MeshShape, wrap_shard_map
from .collectives import bucketed_psum, cross_pod_mean, psum_tree
from .elastic import choose_mesh_shape, make_elastic_mesh, reshard_state
from .sharding import (
    Sharding,
    axis_sizes,
    batch_shardings,
    batch_spec,
    cache_shardings,
    cache_spec,
    constrain_sp,
    current_mesh,
    opt_state_shardings,
    param_layout,
    param_spec,
    params_shardings,
)

__all__ = [
    # the reference's names
    "wrap_shard_map", "bucketed_psum", "cross_pod_mean", "psum_tree",
    "choose_mesh_shape", "make_elastic_mesh", "reshard_state",
    "batch_shardings", "batch_spec", "cache_shardings", "cache_spec",
    "constrain_sp", "current_mesh", "opt_state_shardings", "param_layout", "param_spec", "params_shardings",
    # the port's own
    "MeshShape", "Sharding", "axis_sizes",
]
