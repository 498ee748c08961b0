"""Sharding rules of the port: FSDP(+pod) x TP over the production mesh —
``repro/distributed/sharding.py``, rule for rule.

Mesh axes: (``pod``,) ``data``, ``model``.
  * params/optimizer state: the largest shardable dim goes to the fsdp axes
    (pod+data, ZeRO-3 style), a second dim to ``model`` (TP): divisibility
    checked per dim, with replication where it fails;
  * MoE expert stacks shard the expert dim over ``model`` when divisible
    (expert parallelism), else the ffn dim;
  * activations/batch shard over (pod, data) when the batch divides, else
    over ``data`` alone, else replicate;
  * vocab-parallel logits: last dim of logits on ``model``.

A **spec** is a plain tuple with one entry per dim, in the normal form of
the reference's ``PartitionSpec`` under jax 0.9.0: ``None`` for an
unsharded dim, a one-axis entry written as the axis name (``"data"``, never
``("data",)``), several axes as a tuple (``("pod", "data")``), an empty one
as ``None``.  So ``tuple(reference_spec) == port_spec`` compares them.  A
**sharding** is ``Sharding(mesh, placements, spec)``: the counterpart of
``NamedSharding``, with one DTensor placement per mesh dim
(``core.shard.layout_to_placements``).

A mesh is a ``DeviceMesh``, or a shape-only ``MeshShape`` (or any mesh with
``axis_names`` and a ``shape`` dict): ``axis_sizes`` reads each, so the
rules on a (16, 16) or (2, 16, 16) mesh need no world of 256 ranks.

The models' sequence-parallel hooks read ``current_mesh``: the mesh a
``with core.comm.mesh_scope(mesh):`` block installs, the port's ``with
mesh:``.  In SPMD every rank holds plain tensors, its own values, which a
hook returns as they are; a ``DTensor`` is redistributed to the
placements the reference's constraint names.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from ..core.shard import layout_to_placements, mesh_sizes, spec_to_layout


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: the mesh, one DTensor placement per
    mesh dim, and the spec those placements spell."""

    mesh: Any
    placements: tuple
    spec: tuple


def sharding(mesh, spec: tuple) -> Sharding:
    """The ``Sharding`` of ``spec`` on ``mesh``."""
    return Sharding(mesh, tuple(layout_to_placements(spec_to_layout(spec, len(spec)), mesh)),
                    tuple(spec))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or a
    shape-only mesh with ``axis_names`` and a ``shape`` dict."""
    return mesh_sizes(mesh)


def _norm(e):
    """One spec entry in normal form (module docstring)."""
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def fsdp_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def param_spec(path: str, shape: Tuple[int, ...], mesh, stacked: bool = False) -> tuple:
    """Sharding spec for one parameter.  ``stacked`` marks a leading
    layer-stack dim (from scan-over-layers) that stays unsharded."""
    fsdp = fsdp_axes(mesh)
    dims: list = [None] * len(shape)
    body = list(range(1, len(shape))) if stacked else list(range(len(shape)))
    if not body:
        return tuple(dims)
    # vocab-parallel embedding/unembed: the vocab dim goes to 'model' so the
    # logits come out vocab-sharded (Megatron-style); d to fsdp
    if ("embed/tok" in path or "embed/unembed" in path) and len(body) == 2:
        a, b = body
        vdim, ddim = (a, b) if shape[a] >= shape[b] else (b, a)
        if _divisible(shape[vdim], mesh, "model"):
            dims[vdim] = "model"
        if _divisible(shape[ddim], mesh, fsdp):
            dims[ddim] = fsdp
        return tuple(_norm(e) for e in dims)
    # MoE expert stacks: (L?, E, d, f), the expert dim to model if divisible
    is_expert = "wi" in path or "wg" in path or "wo" in path
    if len(body) == 3 and is_expert:
        e, d, f = body
        if _divisible(shape[e], mesh, "model"):
            dims[e] = "model"
            if _divisible(shape[d], mesh, fsdp):
                dims[d] = fsdp
        else:
            if _divisible(shape[f], mesh, "model"):
                dims[f] = "model"
            if _divisible(shape[d], mesh, fsdp):
                dims[d] = fsdp
        return tuple(_norm(e) for e in dims)
    if len(body) >= 2:
        a, b = body[-2], body[-1]
        # 2-D weight (d_in, d_out): fsdp on the bigger dim, model on the other
        big, small = (a, b) if shape[a] >= shape[b] else (b, a)
        if _divisible(shape[big], mesh, fsdp):
            dims[big] = fsdp
        if _divisible(shape[small], mesh, "model"):
            dims[small] = "model"
        elif dims[big] is None and _divisible(shape[small], mesh, fsdp):
            dims[small] = fsdp
        return tuple(_norm(e) for e in dims)
    # 1-D params (norm gains, biases): shard over model when large+divisible
    d = body[0]
    if shape[d] >= 4096 and _divisible(shape[d], mesh, "model"):
        dims[d] = "model"
    return tuple(dims)


def param_layout(path: str, shape: Tuple[int, ...], mesh, stacked: bool = False):
    """The ``core.shard`` layout tuple for one parameter: the placement
    ``param_spec`` names, in the form ``compile_module(...,
    param_layouts=)`` and the ShardingPass take."""
    return spec_to_layout(param_spec(path, shape, mesh, stacked=stacked), len(shape))


def _walk(node, leaf, path: str = "", stacked: bool = False, stacked_keys=()):
    """``leaf(path, tensor, stacked)`` over a tree of dicts, lists and
    tuples (NamedTuples by their fields; a ``Sharding`` is a leaf), the
    structure kept."""
    if isinstance(node, Sharding):
        return leaf(path, node, stacked)
    if isinstance(node, dict):
        return {k: _walk(v, leaf, f"{path}/{k}", stacked or k in stacked_keys, stacked_keys)
                for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        vals = [_walk(v, leaf, f"{path}/{i}", stacked, stacked_keys) for i, v in enumerate(node)]
        return type(node)(*vals) if hasattr(node, "_fields") else type(node)(vals)
    return leaf(path, node, stacked)


def params_shardings(param_tree, mesh, stacked_keys=("layers", "enc_layers")):
    """A ``Sharding`` tree matching ``param_tree`` (tensors, meta tensors
    included)."""
    return _walk(param_tree,
                 lambda path, t, st: sharding(mesh, param_spec(path, tuple(t.shape), mesh, st)),
                 stacked_keys=stacked_keys)


def batch_axes(mesh, global_batch: int):
    """Largest prefix of (pod, data) that divides the batch."""
    names = axis_sizes(mesh)
    chosen: list = []
    for a in (a for a in ("pod", "data") if a in names):
        if global_batch % axis_size(mesh, tuple(chosen + [a])) == 0:
            chosen.append(a)
    return tuple(chosen)


def batch_spec(mesh, global_batch: int, rank: int) -> tuple:
    axes = batch_axes(mesh, global_batch)
    dims: list = [None] * rank
    if axes:
        dims[0] = axes if len(axes) > 1 else axes[0]
    return tuple(dims)


def batch_shardings(batch_tree, mesh, global_batch: int):
    return _walk(batch_tree,
                 lambda path, t, st: sharding(mesh, batch_spec(mesh, global_batch, len(t.shape))))


def cache_spec(path: str, shape: Tuple[int, ...], mesh, global_batch: int) -> tuple:
    """KV/SSM cache sharding: (L, B, S|state...), batch over (pod, data)
    when divisible; KV heads over 'model' when they divide it, else the
    head dim; the sequence dim stays unsharded so a one-token cache write
    never reshards.  SSM state heads over 'model'."""
    dims: list = [None] * len(shape)
    baxes = batch_axes(mesh, global_batch)
    if len(shape) >= 2 and baxes:
        dims[1] = baxes if len(baxes) > 1 else baxes[0]
    leaf = path.split("/")[-1]
    model = axis_size(mesh, "model")
    if leaf in ("k_scale", "v_scale") and len(shape) == 4:
        # (L, B, W, Hkv) int8-cache scale planes: batch + heads when divisible
        if _divisible(shape[3], mesh, "model") and shape[3] >= model:
            dims[3] = "model"
        return tuple(dims)
    if leaf in ("k", "v", "xk", "xv") and len(shape) == 5:
        # (L, B, S, Hkv, hd)
        if _divisible(shape[3], mesh, "model") and shape[3] >= model:
            dims[3] = "model"
        elif _divisible(shape[4], mesh, "model"):
            dims[4] = "model"
    if leaf == "ssm" and len(shape) == 5:
        # (L, B, H, P, N): heads over model
        if _divisible(shape[2], mesh, "model"):
            dims[2] = "model"
    return tuple(dims)


def cache_shardings(cache_tree, mesh, global_batch: int):
    return _walk(cache_tree,
                 lambda path, t, st: sharding(mesh, cache_spec(path, tuple(t.shape), mesh,
                                                              global_batch)))


def current_mesh() -> Optional[Any]:
    """The mesh installed by a ``with mesh_scope(mesh):`` block, if any."""
    from ..core import comm

    return comm.active_mesh()


def constrain(x, spec: tuple):
    """``x`` under ``spec`` on the current mesh: a ``DTensor`` is
    redistributed to the spec's placements; a plain tensor (a rank's own
    value in SPMD) is returned as it is, the same object."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = layout_to_placements(spec_to_layout(spec, x.ndim), mesh)
    if list(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain_sp(x):
    """Sequence-parallel constraint on a (B, S, d) residual-stream tensor:
    batch over (pod, data) when divisible, SEQUENCE over 'model'.  No-op
    outside a mesh, on fewer than 3 dims, or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or x.ndim < 3 or "model" not in axis_sizes(mesh):
        return x
    baxes = batch_axes(mesh, x.shape[0])
    seq_ax = "model" if x.shape[1] % axis_size(mesh, "model") == 0 else None
    spec = [baxes if len(baxes) > 1 else (baxes[0] if baxes else None), seq_ax]
    spec += [None] * (x.ndim - 2)
    return constrain(x, tuple(spec))


def opt_state_shardings(opt_specs, params_shard, mesh):
    """AdamW m/v mirror the param shardings; step is replicated."""
    from ..train.optimizer import AdamWState

    def same(path, s, stacked):
        return s

    return AdamWState(step=sharding(mesh, ()), m=_walk(params_shard, same),
                      v=_walk(params_shard, same))
