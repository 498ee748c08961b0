"""The port's collectives at run time: mesh axes to process groups, and each
collective instruction as ``torch.distributed`` calls.

The reference runs one controller: ``shard_map`` binds the mesh axes and a
collective instruction lowers to ``lax.psum`` and its kin.  The port runs
SPMD, one process per rank in a ``torch.distributed`` world, so a
collective step calls ``torch.distributed`` on the process group of its
instruction's ``axes``:

  * one axis is ``mesh.get_group(name)``;
  * several axes are one group over the ranks that differ only in those
    dims, made once per mesh with ``new_subgroups_by_enumeration`` (every
    rank makes every group, in one order) and cached by the mesh's names,
    shape and ranks for as long as the world they were made in lasts.
    Their ranks are in mesh order, so a gather over ``("pod", "data")``
    stacks pod-major, as the reference's ``all_gather`` over those axes
    does.

How an op runs on a group is fixed by the group's backend and the tensors'
device (``collective_form``), never found out by catching an error: an op
the backend runs on those tensors is ``"native"``; one it lacks is
``"composed"`` from ops it has (``COMPOSED``).  A gather or scatter along a
dim other than 0 moves that dim to the front around the dim-0 call.

Outside a plan, ``apply_op`` finds its group through ``mesh_scope`` (the
mesh a ``with mesh_scope(mesh):`` block installs) or, with none, the
default world; with no world it raises naming the instruction.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

#: (backend, device type, opcode) the port composes from other ops of that
#: backend.  gloo's functional all-gather of CUDA tensors kills the process
#: (SIGSEGV, torch 2.11.0+cu128 on an H100), where its list all-gather of
#: the same tensors runs: the composed gather is that one.
COMPOSED = frozenset({("gloo", "cuda", "all_gather")})

_ACTIVE_MESH: list = []
#: the several-axes groups, keyed by (mesh contents, axes), and the world
#: they were made in: a destroyed or new world empties the cache
_GROUPS: Dict[str, object] = {"world": None, "groups": {}}


def world_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def _mesh_key(mesh) -> tuple:
    """What a mesh is: its dim names, shape and ranks.  Two meshes with one
    key in one world have the same groups."""
    return (tuple(mesh.mesh_dim_names or ()), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()))


def _world_groups() -> Dict[tuple, object]:
    """The cached groups of the current world.  The cache holds its world,
    so no later world can take that world's identity."""
    world = dist.group.WORLD if world_ready() else None
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["groups"] = world, {}
    return _GROUPS["groups"]


def active_mesh():
    """The mesh of the innermost ``mesh_scope`` block, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


@contextlib.contextmanager
def mesh_scope(mesh):
    """Collectives evaluated outside a plan (``apply_op``) take their groups
    from ``mesh`` inside this block, and the models' sharding hooks
    (``distributed.sharding.current_mesh``) see it: the port's ``with
    mesh:``."""
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def axis_group(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ only in ``axes``' mesh
    dims: ``mesh.get_group`` for one axis; for several, one group per
    combination of the other dims, all made the first time any rank asks
    (a collective call of the whole world) and cached per mesh contents in
    the current world."""
    axes = tuple(axes)
    names = list(mesh.mesh_dim_names or ())
    for a in axes:
        if a not in names:
            raise ValueError(f"collective over axis {a!r}; the mesh has axes {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx) or len(set(idx)) != len(idx):
        raise ValueError(f"collective axes {axes} must be distinct and in mesh order {names}")
    groups = _world_groups()
    key = (_mesh_key(mesh), axes)
    if key not in groups:
        rest = [i for i in range(len(names)) if i not in idx]
        grid = mesh.mesh.permute(*rest, *idx).reshape(-1, _prod(mesh.shape[i] for i in idx))
        mine, _ = dist.new_subgroups_by_enumeration([row.tolist() for row in grid])
        groups[key] = mine
    return groups[key]


def group_names(mesh) -> Dict[str, Tuple[str, ...]]:
    """{process group name: mesh axes} for the mesh's one-dim groups and the
    several-dim groups made so far: how a captured collective, which names
    its group, maps back to the axes it reduces over."""
    out = {mesh.get_group(a).group_name: (a,) for a in (mesh.mesh_dim_names or ())}
    mine = _mesh_key(mesh)
    for (key, axes), g in _world_groups().items():
        if key == mine and g is not None:
            out[g.group_name] = axes
    return out


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def collective_form(opcode: str, group, device) -> str:
    """``"native"`` where ``group``'s backend runs ``opcode`` on tensors of
    ``device``, ``"composed"`` where the port composes it (``COMPOSED``)."""
    key = (backend_of(group), torch.device(device).type, opcode)
    return "composed" if key in COMPOSED else "native"


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def default_group(instr):
    """The group ``apply_op`` uses for ``instr`` outside a plan: the active
    ``mesh_scope``'s group of its axes, else the default world."""
    if _ACTIVE_MESH:
        return axis_group(_ACTIVE_MESH[-1], tuple(instr.attrs["axes"]))
    if not world_ready():
        raise RuntimeError(
            f"{instr.name}: collective {instr.opcode} over {tuple(instr.attrs['axes'])} "
            "needs a torch.distributed world, and there is no process group "
            "(init_process_group, or a plan compiled with mesh=)"
        )
    return dist.group.WORLD


def run_collective(instr, x: torch.Tensor, group=None, form: Optional[str] = None) -> torch.Tensor:
    """One collective instruction on ``x`` over ``group`` (default:
    ``default_group``), in ``form`` (default: ``collective_form``)."""
    if group is None:
        group = default_group(instr)
    op = instr.opcode
    if op == "all_reduce":
        return all_reduce(x, group)
    n = dist.get_world_size(group)
    if int(instr.attrs["group_size"]) != n:
        raise RuntimeError(
            f"{instr.name}: group_size {instr.attrs['group_size']} but the process "
            f"group of {tuple(instr.attrs['axes'])} holds {n} ranks"
        )
    dim = int(instr.attrs["dim"])
    if form is None:
        form = collective_form(op, group, x.device)
    if op == "all_gather":
        return all_gather(x, dim, group, form)
    if op == "reduce_scatter":
        return reduce_scatter(x, dim, group, form)
    raise ValueError(f"{instr.name}: {op} is not a collective")


# The calls below are the ``_c10d_functional`` ops, the ones a captured
# function holds: the same names in every torch the port runs on, where
# ``torch.distributed``'s tensor forms warn as deprecated.

def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(x.contiguous(), "sum", group.group_name))


def all_gather(x: torch.Tensor, dim: int, group, form: Optional[str] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order;
    ``form`` as ``collective_form`` says (by default it decides)."""
    c10d = torch.ops._c10d_functional
    n = dist.get_world_size(group)
    if form is None:
        form = collective_form("all_gather", group, x.device)
    if form == "composed":
        # the list all-gather, one buffer a rank, then one concatenation
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)
    front = x.movedim(dim, 0).contiguous()
    out = c10d.wait_tensor(c10d.all_gather_into_tensor(front, n, group.group_name))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group, form: Optional[str] = None) -> torch.Tensor:
    """This rank's chunk, along ``dim``, of the sum of ``x`` over ``group``."""
    c10d = torch.ops._c10d_functional
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = c10d.wait_tensor(c10d.reduce_scatter_tensor(front, "sum", n, group.group_name))
    return out.movedim(0, dim).contiguous()
