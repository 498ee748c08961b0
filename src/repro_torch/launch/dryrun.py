"""Multi-pod dry run — the reference's ``repro/launch/dryrun.py`` in torch:
every (architecture x input shape) cell on the production meshes, on
``meta`` tensors (no allocation), as rank 0 of a fake world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]

The reference forces a 512-device host and lets XLA compile each cell.
The port starts a fake process group (torch's in-process ``fake`` backend,
``torch.testing._internal.distributed.fake_pg``: collectives return at
once, nothing moves) of 256 or 512 ranks, builds the production mesh over
it and runs, as rank 0, the port's per-rank function of the cell on meta
tensors:

  * train: the sharded step (``make_sharded_train_step``) with
    ``activation_sharding="sp"``, params and AdamW state as rank 0's
    blocks under ``params_shardings`` / ``opt_state_shardings``;
  * prefill: SP, the logits of the last position of rank 0's rows;
  * decode: one token against an int8 KV cache whose blocks lie under
    ``cache_shardings``.

Per cell: ``flops``, ``dot_flops``, ``bytes_accessed`` and ``bytes_min``
from ``costmodel.fn_cost`` on the GLOBAL logical function (the unsharded
step on global shapes); ``collective_bytes`` from ``hlostats`` on rank 0's
run; ``memory.argument_size_in_bytes`` = rank 0's blocks (params, m, v,
step, its cache block) and its rows of the batch, exactly;
``temp_size_in_bytes`` = the peak of live bytes of the storages rank 0's
run makes (an estimate: allocator slack, fragmentation and the
workspaces of library kernels are not seen).  XLA's fields with no
counterpart here (``xla_flops``, ``xla_bytes_accessed``,
``generated_code_size_in_bytes``, the unscaled HLO census) are null.
Records go to ``--out`` as JSON, which ``launch/roofline.py`` reads.

Counting runs each op once per trip of the port's Python loops, so a
cell costs time in proportion to its op count: a train_4k cell of a
24-layer model takes tens of seconds, a 32k prefill far longer (its
attention runs 64 x 64 chunk pairs a layer).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..configs import ARCHITECTURES, SHAPES, get_config
from ..core import comm
from ..core.shard import block_cuts, local_block, spec_to_layout
from ..distributed.sharding import (
    axis_size,
    batch_axes,
    cache_shardings,
    opt_state_shardings,
    params_shardings,
)
from ..models import decode_step, forward, init_cache, param_specs
from ..models.module import tree_leaves, tree_map
from ..train import AdamWConfig, AdamWState, adamw_init_specs, make_train_step
from ..train.sharded import make_sharded_train_step, rank_rows
from .mesh import make_production_mesh

META = torch.device("meta")


# ----------------------------------------------------------------- specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def cache_specs(cfg, B: int, S: int):
    """``init_cache``'s tree as meta tensors: made under a fake-tensor mode,
    so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cache = init_cache(cfg, B, S, device="cpu")
    return tree_map(lambda t: _meta(t.shape, t.dtype), cache)


def input_specs(arch: str, shape_name: str, cfg=None, shape=None) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of the cell: the
    reference's ``ShapeDtypeStruct``s, shape and dtype for shape and dtype.
    ``shape`` (seq_len, global_batch, kind) stands for a cell outside
    ``SHAPES``."""
    cfg = cfg or get_config(arch)
    sh = shape or SHAPES[shape_name]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    i32 = torch.int32
    d = cfg.d_model
    if kind in ("train", "prefill"):
        if cfg.family == "vlm":
            text = S - cfg.num_patches
            batch = {
                "tokens": _meta((B, text), i32),
                "labels": _meta((B, text), i32),
                "patches": _meta((B, cfg.num_patches, d), cfg.torch_dtype),
            }
        elif cfg.family == "audio":
            batch = {
                "tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32),
                "frames": _meta((B, cfg.encoder_seq, d), cfg.torch_dtype),
            }
        else:
            batch = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        if kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((B,), i32), "pos": _meta((B,), i32), "cache": cache_specs(cfg, B, S)}


def cell_is_skipped(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return (
            "skipped: pure full-attention arch — 524k dense-attention decode "
            "is quadratic-cost with no sub-quadratic mechanism in this "
            "config (DESIGN.md §Arch-applicability)"
        )
    return None


_STASH_BUDGET = 6e9  # target per-device remat-carry bytes for train cells


def auto_accum(cfg, B: int, S: int, mesh) -> int:
    """Gradient-accumulation steps so the per-device stash (L x microbatch
    x S x d x 2B) fits the budget: the reference's rule, on any mesh with
    named axis sizes (a ``DeviceMesh`` or a ``MeshShape``)."""
    shards = axis_size(mesh, batch_axes(mesh, B)) or 1
    b_local = max(1, B // shards)
    stash_per_seq = cfg.num_layers * S * cfg.d_model * 2
    seqs = max(1, int(_STASH_BUDGET // max(stash_per_seq, 1)))
    accum = max(1, -(-b_local // seqs))        # ceil
    if cfg.family == "moe":
        # MoE dispatch tensors scale with microbatch tokens:
        # E*C*d ~ 1.25*k*T_micro*d; keep the f32 worst case under ~3 GB.
        disp = 1.25 * cfg.moe_top_k * B * S * cfg.d_model * 4
        accum = max(accum, -(-int(disp) // int(3e9)))
    accum = min(accum, b_local)
    while b_local % accum:
        accum += 1
    return min(accum, b_local)


# ------------------------------------------------------------- the cells
def place_meta(tree, shardings):
    """Each meta tensor of ``tree`` as a ``DTensor`` holding this rank's
    block under its ``Sharding`` (a cut, no communication, nothing
    allocated)."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding import _walk

    flat = []
    _walk(shardings, lambda path, s, stacked: flat.append(s))
    it = iter(flat)

    def one(t):
        s = next(it)
        local = local_block(t, block_cuts(spec_to_layout(s.spec, t.ndim), s.mesh))
        return DTensor.from_local(local, s.mesh, list(s.placements), run_check=False,
                                  shape=tuple(t.shape), stride=t.stride())

    return tree_map(one, tree)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += int(t.numel()) * t.element_size()
    return total


def rank_argument_bytes(params, opt_state, rows) -> int:
    """What a rank holds to run a step: its blocks of params, m, v and the
    step, and its rows of the batch (``memory.argument_size_in_bytes``)."""
    state = _local_bytes(params)
    if opt_state is not None:
        state += _local_bytes(opt_state.m) + _local_bytes(opt_state.v)
        state += _local_bytes({"step": opt_state.step})
    return state + _local_bytes(rows)


@dataclasses.dataclass
class Cell:
    """A dry-run cell: rank 0's function and arguments, the global logical
    function and its arguments, and rank 0's argument bytes."""

    rank_fn: Any
    rank_args: tuple
    global_fn: Any
    global_args: tuple
    argument_bytes: int
    accum_steps: int


def _gather_params(params, mesh):
    from ..core.shard import assemble, dtensor_layout

    return tree_map(lambda p: assemble(p.to_local(), dtensor_layout(p), mesh), params)


def build_cell(arch: str, shape_name: str, mesh, accum_steps: int = 0, shape=None,
               opt_cfg: Optional[AdamWConfig] = None) -> Cell:
    """The cell's functions on ``mesh`` (a ``DeviceMesh`` of the current
    world, this process its rank 0).  ``shape`` stands for a cell outside
    ``SHAPES``; ``opt_cfg`` for the reference's ``AdamWConfig(total_steps=
    10000)``."""
    cfg = get_config(arch)
    sh = shape or SHAPES[shape_name]
    B, kind = sh["global_batch"], sh["kind"]
    if kind in ("train", "prefill"):
        # sequence-parallel residual stream, as the reference's cells
        cfg = dataclasses.replace(cfg, activation_sharding="sp")
    if kind == "decode" and cfg.family != "ssm":
        # int8 KV cache: halves cache bandwidth and footprint
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if accum_steps == 0 and kind == "train":
        accum_steps = auto_accum(cfg, B, sh["seq_len"], mesh)
    accum_steps = max(1, accum_steps)
    specs = input_specs(arch, shape_name, cfg, sh)
    pspecs = param_specs(cfg)
    pshard = params_shardings(pspecs, mesh)
    params = place_meta(pspecs, pshard)

    if kind == "train":
        ospecs = adamw_init_specs(pspecs)
        oshard = opt_state_shardings(ospecs, pshard, mesh)
        opt = AdamWState(place_meta({"s": ospecs.step}, {"s": oshard.step})["s"],
                         place_meta(ospecs.m, oshard.m), place_meta(ospecs.v, oshard.v))
        ocfg = opt_cfg or AdamWConfig(total_steps=10000)
        rank_step = make_sharded_train_step(cfg, ocfg, mesh, accum_steps=accum_steps)
        mb = {k: v[: v.shape[0] // accum_steps] for k, v in specs.items()}
        rows = {k: v.repeat((accum_steps,) + (1,) * (v.ndim - 1))
                for k, v in rank_rows(mb, mesh).items()}
        return Cell(rank_step, (params, opt, specs),
                    make_train_step(cfg, ocfg, accum_steps=accum_steps),
                    (pspecs, ospecs, specs), rank_argument_bytes(params, opt, rows), accum_steps)

    if kind == "prefill":
        from ..models import layers as mlayers

        def prefill(p, batch):
            # serving prefill: next-token logits for the LAST position only
            hidden = forward(p, batch, cfg, return_hidden=True)
            return mlayers.unembed(p["embed"], hidden[:, -1]).to(torch.float32)

        def rank_prefill(p, batch):
            with comm.mesh_scope(mesh):
                return prefill(_gather_params(p, mesh), rank_rows(batch, mesh))

        return Cell(rank_prefill, (params, specs), prefill, (pspecs, specs),
                    rank_argument_bytes(params, None, rank_rows(specs, mesh)), accum_steps)

    # decode
    cshard = cache_shardings(specs["cache"], mesh, B)
    cache = place_meta(specs["cache"], cshard)
    baxes = batch_axes(mesh, B)

    def serve_step(p, c, tokens, pos):
        return decode_step(p, c, tokens, pos, cfg)

    def rows(x):
        return local_block(x, block_cuts(spec_to_layout((baxes or None,), x.ndim), mesh))

    def rank_serve_step(p, c, tokens, pos):
        """Rank 0's decode: the whole params and its batch rows' cache (its
        block gathered over every axis but the batch's), then its block of
        the new cache kept."""
        from ..core.shard import assemble, dtensor_layout

        def rows_cache(t):
            lay = dtensor_layout(t)
            keep = tuple(e if d == 1 else None for d, e in enumerate(lay))
            rest = tuple(None if d == 1 else e for d, e in enumerate(lay))
            return assemble(t.to_local(), rest, mesh), keep, lay

        with comm.mesh_scope(mesh):
            full = _gather_params(p, mesh)
            local = tree_map(rows_cache, c)
            logits, new = serve_step(full, tree_map(lambda x: x[0], local), rows(tokens), rows(pos))
            out = tree_map(lambda n, x: local_block(
                n, block_cuts(tuple(None if d == 1 else e for d, e in enumerate(x[2])), mesh)),
                new, local)
        return logits, out

    args_bytes = rank_argument_bytes(params, None, {"cache": cache, "tokens": rows(specs["tokens"]),
                                                    "pos": rows(specs["pos"])})
    return Cell(rank_serve_step, (params, cache, specs["tokens"], specs["pos"]), serve_step,
                (pspecs, specs["cache"], specs["tokens"], specs["pos"]), args_bytes, accum_steps)


# ------------------------------------------------------------- one cell
def fake_world(world: int) -> bool:
    """Start an in-process fake process group of ``world`` ranks, this
    process rank 0, when no world is up; True when this call started it
    (and its caller destroys it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is up; "
                               f"the dry run needs {world}")
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def measure_cell(cell: Cell, mesh_name: str, num_devices: int, arch: str, shape_name: str,
                 build_s: float) -> Dict[str, Any]:
    """Count both functions of a built cell: the record's numbers."""
    from . import hlostats
    from .costmodel import count, fn_cost, nbytes, _tensors

    t0 = time.time()
    jcost = fn_cost(cell.global_fn, *cell.global_args)     # global logical cost
    out, mode = count(cell.rank_fn, *cell.rank_args)        # rank 0's run
    count_s = time.time() - t0
    coll = hlostats.collective_bytes(mode)

    def local(t):
        from torch.distributed.tensor import DTensor

        return t.to_local() if isinstance(t, DTensor) else t

    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "num_devices": num_devices,
        "flops": float(jcost["flops"]),
        "dot_flops": float(jcost["dot_flops"]),
        "bytes_accessed": float(jcost["bytes"]),
        "bytes_min": float(jcost["bytes_min"]),
        "xla_flops": None,
        "xla_bytes_accessed": None,
        "collective_bytes": coll,
        "collective_bytes_unscaled": None,
        "collective_calls": len(mode.collectives),
        "memory": {
            "argument_size_in_bytes": cell.argument_bytes,
            "output_size_in_bytes": sum(nbytes(local(t)) for t in _tensors(out)),
            "temp_size_in_bytes": mode.peak_live_bytes,
            "generated_code_size_in_bytes": None,
        },
        "lower_s": round(build_s, 2),
        "compile_s": round(count_s, 2),
        "ops_counted": sum(mode.ops.values()),
        "accum_steps": cell.accum_steps,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum_steps: int = 0, verbose: bool = True) -> Dict[str, Any]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skip": skip}
    import torch.distributed as dist

    world = 512 if multi_pod else 256
    started = fake_world(world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        cell = build_cell(arch, shape_name, mesh, accum_steps)
        rec = measure_cell(cell, mesh_name, world, arch, shape_name, time.time() - t0)
    finally:
        if started:
            dist.destroy_process_group()
    if verbose:
        print(f"[{rec['mesh']}] {arch} x {shape_name}: "
              f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"coll={sum(rec['collective_bytes'].values()):.3e}B "
              f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.2f}GiB "
              f"(build {rec['lower_s']:.1f}s count {rec['compile_s']:.1f}s)")
        print("  memory:", rec["memory"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="both")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--accum-steps", type=int, default=0)  # 0 = auto
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(ARCHITECTURES) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {tag}")
                    continue
                try:
                    rec = run_cell(arch, shape, mp, args.accum_steps)
                except Exception as e:  # noqa: BLE001 — record the failure
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16", "error": repr(e)[:2000]}
                    print(f"[FAIL] {tag}: {e}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
