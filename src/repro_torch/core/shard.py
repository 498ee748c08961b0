"""Shard layouts of the port — ``repro/core/shard.py``: how a module's
*local* (per-shard) tensors relate to the global tensors of a multi-rank run.

Shard-aware compilation plans the per-shard computation (the body every
rank runs), so every instruction shape in the module is already the LOCAL
shape: fusion and the latency model score per-shard tiles unchanged.  What
the local shapes cannot express is *placement*: which global dims are split
over which mesh axes, and whether a value is a pending partial sum (a
contraction over a sharded dim that still needs an ``all_reduce``).  This
module defines that annotation and propagates it, rule for rule the
reference's.

A **layout** is a tuple with one entry per dim: ``None`` (not sharded) or a
tuple of mesh axis names the global dim is split over, e.g.
``(("model",), None)`` for a row-sharded matrix.  ``None`` in place of the
whole tuple means *unknown*: propagation lost track (an unmapped reshape),
which is distinct from replicated; unknown layouts are never stamped and
never validated against.

``propagate_layouts`` walks a module once, derives a layout for every
instruction from the parameter layouts, stamps non-trivial results into
``instr.attrs["shard"]`` (and pending partial-sum axes into
``attrs["partial"]``), and validates collectives against the mesh.  The
stamped attrs flow into ``fusion_signature``/``module_signature``, so the
kernel cache can never alias a per-shard kernel with a full-shape one.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (named dims,
``mesh_dim_names`` and a ``shape`` tuple), or, where only its shape
matters, a ``MeshShape`` or any object with an ``axis_names`` tuple and a
``shape`` dict (``mesh_sizes`` reads all three).  ``layout_to_placements``
takes the place of the reference's ``layout_to_pspec``: a DTensor placement
per mesh dim.  The reference's ``names_to_layout`` (shard_map's
``in_names`` dicts) has no counterpart: the port has no ``shard_map``.
``wrap_shard_map`` is the port's eager form of it: every rank of the world
runs the per-shard function on its blocks of global arguments, and the
outputs are gathered back to global ones (``block_cuts``, ``local_block``
and ``assemble`` are its steps, which the sharded plan's replay shares).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .ir import COLLECTIVE_OPCODES, Module

#: one entry per dim: None (unsharded) or a tuple of mesh axis names
Layout = Tuple[Optional[Tuple[str, ...]], ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh by its shape alone: named dims and their sizes, major to
    minor, with a ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``.  The
    distribution rules and the planner read only this, so a (16, 16) or
    (2, 16, 16) mesh needs no world of 256 ranks."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"MeshShape: {len(self.names)} names for {len(self.sizes)} sizes")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"MeshShape: sizes must be >= 1, got {self.sizes}")

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.sizes)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, major to minor, of a ``DeviceMesh``, a
    ``MeshShape`` or a shape-only mesh with ``axis_names`` and a ``shape``
    dict (the reference's tests' ``FakeMesh``)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return {str(a): int(shape[a]) for a in mesh.axis_names}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a mesh for sharding needs named dims (mesh_dim_names)")
    return {str(a): int(s) for a, s in zip(names, tuple(shape), strict=True)}


def spec_to_layout(spec, rank: int) -> Layout:
    """A per-dim spec (``None``, an axis name or a tuple of names per dim)
    -> canonical layout tuple."""
    entries = tuple(spec) if spec is not None else ()
    out: List[Optional[Tuple[str, ...]]] = []
    for i in range(rank):
        e = entries[i] if i < len(entries) else None
        if e is None:
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e) or None)
    return tuple(out)


def layout_to_placements(layout: Optional[Layout], mesh) -> list:
    """Layout -> one DTensor placement per mesh dim: ``Shard(d)`` on every
    mesh dim that splits tensor dim ``d``, ``Replicate()`` elsewhere.  A dim
    split over several mesh dims takes them major to minor, as a
    ``PartitionSpec`` orders them and as DTensor shards in mesh-dim order,
    so ``(("pod", "data"),)`` on a (pod, data, model) mesh gives
    ``[Shard(0), Shard(0), Replicate()]``; the axes of one dim out of mesh
    order have no such placement and raise."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out: list = [Replicate() for _ in names]
    for d, e in enumerate(layout or ()):
        if not e:
            continue
        idx = []
        for a in e:
            if a not in names:
                raise ValueError(f"layout names axis {a!r}; the mesh has {names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} splits two dims of layout {layout}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"dim {d} of layout {layout} lists mesh axes {e} out of mesh order "
                f"{names}: no DTensor placement shards a dim minor to major"
            )
        for i in idx:
            out[i] = Shard(d)
    return out


def block_cuts(layout: Optional[Layout], mesh) -> List[Tuple[int, int, int]]:
    """This rank's block of a global tensor of ``layout``: (dim, block
    index, block count) per sharded dim, the index mixed-radix over the
    dim's axes major to minor from the rank's mesh coordinate."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate(), strict=True))
    cuts = []
    for d, e in enumerate(layout or ()):
        if e:
            idx, n = 0, 1
            for a in e:
                idx, n = idx * sizes[a] + coord[a], n * sizes[a]
            cuts.append((d, idx, n))
    return cuts


def local_block(value, cuts: Sequence[Tuple[int, int, int]]):
    """The block ``cuts`` (``block_cuts``) names of a global tensor, made
    contiguous where it is a slice."""
    for d, idx, n in cuts:
        if value.shape[d] % n:
            raise ValueError(f"dim {d} of size {value.shape[d]} does not split {n} ways")
        size = value.shape[d] // n
        value = value.narrow(d, idx * size, size)
    return value.contiguous() if cuts else value


def assemble(value, layout: Optional[Layout], mesh):
    """A per-shard output back to its global tensor: one all-gather per
    sharded dim over that dim's axes."""
    from .comm import all_gather, axis_group

    for d, e in enumerate(layout or ()):
        if e:
            value = all_gather(value, d, axis_group(mesh, tuple(e)))
    return value


def placements_to_layout(placements, mesh, rank: int) -> Layout:
    """A DTensor's placements -> its layout: each tensor dim split over the
    mesh dims whose placement is ``Shard`` of it, major to minor (the
    inverse of ``layout_to_placements``)."""
    from torch.distributed.tensor import Shard

    names = list(mesh_sizes(mesh))
    dims: List[List[str]] = [[] for _ in range(rank)]
    for name, p in zip(names, placements, strict=True):
        if isinstance(p, Shard):
            dims[p.dim % rank].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on mesh axis {name!r} is neither Shard nor Replicate")
    return tuple(tuple(e) or None for e in dims)


def dtensor_layout(x) -> Layout:
    """The layout of a ``DTensor`` on its own mesh."""
    return placements_to_layout(x.placements, x.device_mesh, x.ndim)


def gather_dtensor(x):
    """A ``DTensor``'s global value, on every rank, by the port's gathers
    (``assemble``: ``core.comm``, which picks the backend's form), never
    ``full_tensor()``."""
    return assemble(x.to_local(), dtensor_layout(x), x.device_mesh)


def dtensor_like(value, like):
    """This rank's block of the global ``value`` as a ``DTensor`` placed as
    ``like`` is (a cut, no communication)."""
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    local = local_block(value, block_cuts(dtensor_layout(like), mesh))
    return DTensor.from_local(local, mesh, list(like.placements), run_check=False,
                              shape=tuple(value.shape), stride=value.contiguous().stride())


def wrap_shard_map(fn, mesh, in_specs, out_specs):
    """``fn``, the per-shard body, as a function of global arguments: each
    rank runs ``fn`` eagerly on its blocks of the positional arguments
    (``in_specs``, one spec per argument) and returns the global outputs
    (``out_specs``: one spec for a single output, one per output of a
    tuple).  The port's ``jax.jit(shard_map(fn))``: collectives inside
    ``fn`` (``torch.distributed._functional_collectives``) run for real in
    the world."""
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        local = [local_block(a, block_cuts(spec_to_layout(sp, a.ndim), mesh))
                 for a, sp in zip(args, in_specs, strict=True)]
        out = fn(*local)
        if isinstance(out, (tuple, list)):
            return type(out)(assemble(o, spec_to_layout(sp, o.ndim), mesh)
                             for o, sp in zip(out, out_specs, strict=True))
        return assemble(out, spec_to_layout(out_specs, out.ndim), mesh)

    return run


def mesh_axes_of(mesh) -> Tuple[Tuple[str, int], ...]:
    """Hashable (name, size) description of a mesh: what salts the kernel
    cache and the measured-cost store (the mesh object itself never enters
    a fingerprint)."""
    return tuple(mesh_sizes(mesh).items())


def is_trivial_layout(layout: Optional[Layout]) -> bool:
    return layout is None or all(e is None for e in layout)


def _merge(a, b, where: str):
    """Dim-wise merge of two operand layouts (same local shape)."""
    if a is None or b is None:
        return None
    if len(a) != len(b):
        return None
    out = []
    for da, db in zip(a, b, strict=False):
        if da is None or db is None:
            # replicated op sharded: the sharded interpretation wins (a
            # replicated operand holds the same slice-compatible values on
            # every shard along that dim's axes)
            out.append(da or db)
        elif da != db:
            raise ValueError(
                f"shard layout conflict at {where}: dim sharded over {da} "
                f"on one operand and {db} on another"
            )
        else:
            out.append(da)
    return tuple(out)


def derive_layouts(
    module: Module,
    mesh_axes: Sequence[Tuple[str, int]],
    param_layouts: Optional[Dict[str, Layout]] = None,
) -> Tuple[Dict[int, Optional[Layout]], Dict[int, frozenset], Dict[str, int]]:
    """Derive (without stamping) a shard layout for every instruction.

    The pure half of ``propagate_layouts``: walks the module once and
    returns ``(layouts, partial, counters)`` — instruction id to layout
    (None = unknown), instruction id to pending partial-sum axes (only ids
    with a non-empty set appear), and the ``CompileStats`` counters.  The
    verifier calls this directly so it can compare a fresh derivation
    against the stamped attrs without mutating anything.  Raises
    ``ValueError`` on layout conflicts, collectives over axes the mesh does
    not have, or group sizes that disagree with the mesh.
    """
    axis_size = {name: int(size) for name, size in mesh_axes}
    param_layouts = param_layouts or {}
    layouts: Dict[int, Optional[Layout]] = {}
    partial: Dict[int, frozenset] = {}
    replicated_cache: Dict[int, Layout] = {}

    def _replicated(rank: int) -> Layout:
        if rank not in replicated_cache:
            replicated_cache[rank] = tuple([None] * rank)
        return replicated_cache[rank]

    def _group_size(axes: Tuple[str, ...]) -> int:
        g = 1
        for a in axes:
            g *= axis_size[a]
        return g

    n_sharded = n_collectives = 0
    for instr in module.instructions:
        op = instr.opcode
        ops = instr.operands
        in_partial = frozenset().union(*(partial.get(o.id, frozenset()) for o in ops)) if ops else frozenset()
        lay: Optional[Layout]

        if op in COLLECTIVE_OPCODES:
            n_collectives += 1
            axes = tuple(instr.attrs["axes"])
            for a in axes:
                if a not in axis_size:
                    raise ValueError(
                        f"{instr.name}: collective over axis {a!r} but the "
                        f"mesh has axes {sorted(axis_size)}"
                    )
            src = layouts.get(ops[0].id)
            if op == "all_reduce":
                lay = src
                in_partial = in_partial - set(axes)
            elif op == "all_gather":
                if int(instr.attrs["group_size"]) != _group_size(axes):
                    raise ValueError(
                        f"{instr.name}: group_size "
                        f"{instr.attrs['group_size']} != mesh size "
                        f"{_group_size(axes)} of axes {axes}"
                    )
                if src is None:
                    lay = None
                else:
                    d = instr.attrs["dim"]
                    e = src[d]
                    gathered = tuple(a for a in (e or ()) if a not in axes) or None
                    lay = src[:d] + (gathered,) + src[d + 1:]
            else:  # reduce_scatter
                if int(instr.attrs["group_size"]) != _group_size(axes):
                    raise ValueError(
                        f"{instr.name}: group_size "
                        f"{instr.attrs['group_size']} != mesh size "
                        f"{_group_size(axes)} of axes {axes}"
                    )
                in_partial = in_partial - set(axes)
                if src is None:
                    lay = None
                else:
                    d = instr.attrs["dim"]
                    e = tuple((src[d] or ())) + axes
                    lay = src[:d] + (e,) + src[d + 1:]
        elif op == "parameter":
            lay = param_layouts.get(instr.name, _replicated(instr.ndim))
        elif op in ("constant", "iota"):
            lay = _replicated(instr.ndim)
        elif op in ("elementwise", "select"):
            lay = _replicated(instr.ndim)
            for o in ops:
                lay = _merge(lay, layouts.get(o.id), instr.name)
        elif op in ("reshape", "bitcast"):
            src = layouts.get(ops[0].id)
            if src is not None and is_trivial_layout(src):
                lay = _replicated(instr.ndim)
            elif src is not None and len(src) == instr.ndim and tuple(
                ops[0].shape
            ) == tuple(instr.shape):
                lay = src
            else:
                lay = None  # unmapped reshape of a sharded value: unknown
        elif op == "transpose":
            src = layouts.get(ops[0].id)
            perm = instr.attrs["perm"]
            lay = None if src is None else tuple(src[p] for p in perm)
        elif op == "broadcast":
            src = layouts.get(ops[0].id)
            if src is None:
                lay = None
            else:
                out: List[Optional[Tuple[str, ...]]] = [None] * instr.ndim
                for i, d in enumerate(instr.attrs["dims"]):
                    out[d] = src[i]
                lay = tuple(out)
        elif op == "reduce":
            src = layouts.get(ops[0].id)
            dims = set(instr.attrs["dims"])
            if src is None:
                lay = None
            else:
                lay = tuple(e for i, e in enumerate(src) if i not in dims)
                reduced_axes = set()
                for i in dims:
                    reduced_axes.update(src[i] or ())
                if reduced_axes:
                    # each shard reduced only its local slice: partial sum
                    in_partial = in_partial | reduced_axes
        elif op == "dot":
            lhs, rhs = layouts.get(ops[0].id), layouts.get(ops[1].id)
            if lhs is None or rhs is None:
                lay = None
            else:
                batch = _merge(lhs[:-2], rhs[:-2], instr.name)
                lay = (
                    None
                    if batch is None
                    else batch + (lhs[-2], rhs[-1])
                )
                contracted = set(lhs[-1] or ()) | set(rhs[-2] or ())
                if contracted:
                    in_partial = in_partial | contracted
        elif op == "concat":
            lay = _replicated(instr.ndim)
            d = instr.attrs["dim"]
            for o in ops:
                lay = _merge(lay, layouts.get(o.id), instr.name)
                if lay is None:
                    break
            if lay is not None and lay[d] is not None:
                lay = None  # concat along a sharded dim: unknown
        elif op == "gather":
            t, idx = layouts.get(ops[0].id), layouts.get(ops[1].id)
            lay = None if t is None or idx is None else idx + t[1:]
        else:  # call/get and anything future: layout tracking stops
            lay = None

        layouts[instr.id] = lay
        if in_partial:
            partial[instr.id] = in_partial
        if lay is not None and not is_trivial_layout(lay):
            n_sharded += 1

    counters = {"sharded_instrs": n_sharded, "collective_ops": n_collectives}
    return layouts, partial, counters


def propagate_layouts(
    module: Module,
    mesh_axes: Sequence[Tuple[str, int]],
    param_layouts: Optional[Dict[str, Layout]] = None,
) -> Dict[str, int]:
    """Derive and stamp a shard layout for every instruction.

    ``mesh_axes`` is the (name, size) tuple the plan will run on;
    ``param_layouts`` maps parameter names to layouts (missing = replicated).
    Stamps ``attrs["shard"]`` only when the layout is known and non-trivial
    (unsharded compiles stay byte-identical in every signature), and
    ``attrs["partial"]`` with the mesh axes a value is a pending partial sum
    over; stale stamps from an earlier propagation are cleared, so the attrs
    always mirror THIS derivation (the verifier re-derives and compares).
    Raises ``ValueError`` on layout conflicts, collectives over axes the
    mesh does not have, or group sizes that disagree with the mesh.
    Returns counters for ``CompileStats``.
    """
    layouts, partial, counters = derive_layouts(module, mesh_axes, param_layouts)
    for instr in module.instructions:
        in_partial = partial.get(instr.id)
        if in_partial:
            instr.attrs["partial"] = tuple(sorted(in_partial))
        else:
            instr.attrs.pop("partial", None)
        lay = layouts.get(instr.id)
        if lay is not None and not is_trivial_layout(lay):
            instr.attrs["shard"] = lay
        else:
            instr.attrs.pop("shard", None)
    return counters
