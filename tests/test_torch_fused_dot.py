"""The generated fused dot, staged in shared memory, and the row split of a
dot's output on a GPU.

A staged dot (``codegen._Phase.staged_dot_loop``) computes BM x BN tiles of
its output chunk, its block staging k-blocks of both operands in shared
memory, each value (a composed operand computed) once per staging; its
FMAs run in the register-tile loop's order of k.  Under a GPU spec the
planner may also split a batched dot at its output's rows, the rhs read
whole by every block (``schedule.dot_row_split``); under ``TPU_V5E`` it
never does.  Plans and sources are checked as text; the plain kernels run
on the CPU against the JAX package's ``reference_execute`` and ``jax.jit``
of the same function, at ``TOL``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs import ALL_GRAPHS, random_feeds
from repro.core import GraphBuilder
from repro.core import reference_execute as ref_execute
from repro_torch import stitch
from repro_torch.core import StitchOptions, codegen, compile_module, geometry
from repro_torch.core.fusion import FusedComputation
from repro_torch.core.interop import module_from_reference
from repro_torch.core.latency import H100, TPU_V5E, LatencyModel, _dot_reads
from repro_torch.core.memory import plan_stitched_memory
from repro_torch.core.pipeline import default_vmem_limit
from repro_torch.core.schedule import (
    REPLICATED, ROW, PhaseSolution, Sched, StitchedSolution, Unsatisfiable, is_row_split_dot,
    propagate, resolve_schedules)
from test_torch_plan_h100 import _granite_cases, fig3_attention

TOL = 2e-5
SPECS = {"TPU_V5E": TPU_V5E, "H100": H100}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL, err_msg=what)


def _fig3_module(B=1, H=3, S=64, D=16):
    """The Figure-3 attention in the JAX package's GraphBuilder."""
    b = GraphBuilder("fig3")
    q, k, v = (b.parameter(n, (B, H, S, D), jnp.float32) for n in "qkv")
    s = b.dot(q, b.transpose(k, (0, 1, 3, 2)), fusable=True) * (1.0 / D ** 0.5)
    s = s - b.broadcast(b.reduce(s, (3,), "max"), s.shape, (0, 1, 2))
    e = b.exp(s)
    p = e / b.broadcast(b.reduce(e, (3,), "sum"), s.shape, (0, 1, 2))
    b.dot(p, v, fusable=True)
    return b.module


def _fig3_jnp(q, k, v):
    s = jnp.matmul(q, jnp.swapaxes(k, -1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    s = s - jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s)
    return jnp.matmul(e / jnp.sum(e, axis=-1, keepdims=True), v)


def _nmt_jnp(q, k, v, bias):
    s = jnp.matmul(q, jnp.swapaxes(k, -1, -2)) * (1.0 / q.shape[-1] ** 0.5) + bias
    return jnp.tanh(jnp.matmul(jax.nn.softmax(s, axis=-1), v))


CASES = {"NMT": (lambda: ALL_GRAPHS["NMT"](), _nmt_jnp), "fig3_attention": (_fig3_module, _fig3_jnp)}


def _dot_kernels(compiled):
    return [k for k in compiled.kernels if any(m.opcode == "dot" for m in k.fusion.members)]


def _dot_block(source, label):
    """The text of one dot's loop: from its comment to the next member's."""
    return source.split(f"// {label} = dot(")[1].split("\n      // m")[0]


def test_row_split_replicates_no_more_than_the_measured_l2_read():
    # the Figure-3 attention's v (3 MiB) under a spec whose L2 was measured
    # to serve a whole rhs of 1 MiB: the row split is refused
    module = module_from_reference(_fig3_module(S=512, D=64, H=24))
    pv = [i for i in module.instructions if i.opcode == "dot"][-1]
    members = [i for i in module.instructions if i.opcode != "parameter"]
    split = Sched("chunked", 2, 8, ROW)
    small = dataclasses.replace(H100, l2_read_limit=1 << 20)
    assert pv.operands[1].bytesize > small.l2_read_limit
    with pytest.raises(Unsatisfiable):
        resolve_schedules(members, [pv], {pv.id: split}, 512 * 1024, small)
    assert H100.l2_read_limit >= pv.operands[1].bytesize
    resolve_schedules(members, [pv], {pv.id: split}, 512 * 1024, H100)


def test_a_composed_op_with_no_measured_rate_is_priced_at_vpu_flops():
    module = module_from_reference(_fig3_module())
    model = LatencyModel(H100)
    by_fn = {i.attrs.get("fn"): i for i in module.instructions if i.opcode == "elementwise"}
    assert "mul" not in dict(H100.staged_op_rates)
    assert model.composed_rate(by_fn["mul"]) == H100.vpu_flops
    assert model.composed_rate(by_fn["exp"]) == dict(H100.staged_op_rates)["exp"]


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("name", list(CASES))
def test_dot_kernels_stage_k_blocks_in_shared_memory(name, spec):
    build, _ = CASES[name]
    compiled = compile_module(module_from_reference(build()),
                              StitchOptions(device_spec=SPECS[spec]), device="cpu")
    kernels = _dot_kernels(compiled)
    assert kernels
    for k in kernels:
        src = k.fn.source
        tilings = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution,
                                         k.plan).tilings
        label = {m.id: f"m{j}" for j, m in enumerate(k.fusion.members)}
        for mid, t in tilings.items():
            assert t is not None
            batched = f"{t.bg} x " if t.bg > 1 else ""
            assert f"{label[mid]} staged in {batched}{t.bm} x {t.bn} tiles, k steps of {t.bk}" in src
            block = _dot_block(src, label[mid])
            # both operands staged into rows padded against bank conflicts,
            # a barrier, the FMAs from shared memory, a barrier, per k step
            depth = next(m for m in k.fusion.members if m.id == mid).operands[0].shape[-1]
            assert f"for (int k0 = 0; k0 < {depth}; k0 += {t.bk}) {{" in block
            batch = f"ge \\* {t.bk * (t.bm + t.pad)} \\+ " if t.bg > 1 else ""
            assert re.search(rf"sa\[{batch}kk \* {t.bm + t.pad} \+ w\] = ", block)
            batch = f"ge \\* {t.bk * (t.bn + t.pad)} \\+ " if t.bg > 1 else ""
            assert re.search(rf"sb\[{batch}kk \* {t.bn + t.pad} \+ w\] = ", block)
            # f32 register rows and columns read shared memory in 16-byte
            # words (8-byte for two)
            assert t.vec
            for n, name in ((t.rm, "a"), (t.rn, "c")):
                load = f"const float{min(n, 4)} {name}v" if n > 1 else f"const float {name}0 = *("
                assert load in block
            loop = block.split("for (int k0")[1]
            loop = loop[:loop.index("__syncthreads();", loop.index("sx_fma")) + len("__syncthreads();")]
            assert loop.count("__syncthreads();") == 2
            assert "acc[0] = sx_fma(a0, c0, acc[0]);" in loop
            # the FMAs read shared memory only
            fma = loop.split("for (int kk = 0;")[1]
            assert "in0[" not in fma and "in1[" not in fma


def test_a_composed_transpose_is_staged_along_its_contiguous_dimension():
    """q @ transpose(k): the rhs is read along k, the source's contiguous
    dimension, and written transposed into the tile."""
    compiled = compile_module(module_from_reference(ALL_GRAPHS["NMT"]()),
                              StitchOptions(device_spec=H100), device="cpu")
    (k,) = compiled.kernels
    first = next(m for m in k.fusion.members if m.opcode == "dot")
    t = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution, k.plan).tilings[first.id]
    block = _dot_block(k.fn.source, f"m{k.fusion.members.index(first)}")
    rhs = block.split("sb[kk *")[0].rsplit("#pragma unroll", 1)[1]
    # neighbouring threads take neighbouring k: kk follows e % ..., w e / ...
    assert re.search(r"const int kk = e % \d+", rhs) and re.search(r"const int w = e / \d+", rhs)
    assert re.search(r"in\d\[[^\]]* \+ \(k0 \+ kk\)\]", block.split("sb[kk *")[1].split("\n")[0])


def test_a_composed_divide_runs_once_per_staged_element():
    """The Figure-3 attention at granite width under H100: ``e / sum`` is
    composed into the second dot's lhs, which is staged once per column
    tile, and one tile spans all 64 columns: one divide a staged element.
    The register-tile loop composes it into each of its 4 rows' loads, for
    every k, in each of the 16 threads a row of outputs has."""
    fn, args = _granite_cases()["fig3_attention"]
    cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
    (k,) = _dot_kernels(cm)
    dots = [m for m in k.fusion.members if m.opcode == "dot"]
    pv = dots[-1]
    div = pv.operands[0]
    assert div.opcode == "elementwise" and div.attrs["fn"] == "div"
    assert k.plan.action(div) == "INLINE"
    launch = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution, k.plan)
    t = launch.tilings[pv.id]
    assert t.bn == pv.shape[-1] == 64
    assert _dot_reads(pv, div, t, k.solution.assignment[pv.id]) == 1
    block = _dot_block(k.fn.source, f"m{k.fusion.members.index(pv)}")
    # the divide by the row sums' slot: once into the registers that carry
    # k step 0 to shared memory, once into those of each next step
    divides = [line for line in block.splitlines() if re.search(r" / (?:p0s|in)\d+\[", line)]
    assert len(divides) == 2 and all(d.strip().startswith("pa[ek] = ") for d in divides)
    assert "(k0 + 32 + kk)" in divides[1]
    assert not re.search(r" / p0s\d+\[", block.split("for (int kk = 0;")[1])
    # the same plan on the register-tile loop: ``_cuda_fusion`` given the
    # launch with no dot staged
    register_tiles = dataclasses.replace(launch, tilings=dict.fromkeys(launch.tilings))
    _, _, loop, _, _ = codegen._cuda_fusion(k.fusion, k.solution, k.plan, register_tiles)
    block2 = _dot_block(loop, f"m{k.fusion.members.index(pv)}")
    assert "the register-tile loop" in loop.splitlines()[0]
    assert len([line for line in block2.splitlines() if re.search(r" / p0s\d+\[", line)]) == 4


def test_row_split_is_offered_under_a_gpu_spec_only():
    module = module_from_reference(_fig3_module(S=512, D=64, H=24))
    dots = [i for i in module.instructions if i.opcode == "dot"]
    split = Sched("chunked", 2, 8, ROW)
    for d in dots:
        with pytest.raises(Unsatisfiable):
            propagate(d, split)
        assert propagate(d, split, row_split=True) == [split, REPLICATED]
        assert is_row_split_dot(d, split)
    # a 2-D dot keeps the reference's rule: the library's
    b = GraphBuilder("mm")
    b.dot(b.parameter("x", (64, 32), jnp.float32), b.parameter("w", (32, 16), jnp.float32),
          fusable=True)
    (mm,) = [i for i in module_from_reference(b.module).instructions if i.opcode == "dot"]
    with pytest.raises(Unsatisfiable):
        propagate(mm, Sched("chunked", 0, 4, ROW), row_split=True)
    # resolving the root's row split: refused under TPU_V5E; under H100 the
    # rhs (3 MB, past the 512 KiB replicate limit) is read whole from the L2
    pv = dots[-1]
    members = [i for i in module.instructions if i.opcode != "parameter"]
    for spec, ok in ((None, False), (TPU_V5E, False), (H100, True)):
        if not ok:
            with pytest.raises(Unsatisfiable):
                resolve_schedules(members, [pv], {pv.id: split}, 512 * 1024, spec)
            continue
        sol = resolve_schedules(members, [pv], {pv.id: split}, 512 * 1024, spec)
        assert sol.blocks == 24 * 8
        assert sol.assignment[pv.operands[1].id] == REPLICATED
        assert pv.operands[1].bytesize > 512 * 1024


@pytest.mark.parametrize("spec", list(SPECS))
def test_granite_attention_plans_one_kernel_under_h100_only(spec):
    fn, args = _granite_cases()["fig3_attention"]
    opts = StitchOptions(device_spec=SPECS[spec]) if spec == "H100" else StitchOptions(max_blocks=32)
    cm = stitch(fn, options=opts, device="cpu").lower(*args).compile()
    split = [m for k in cm.kernels if k.solution is not None for m in k.fusion.members
             if is_row_split_dot(m, k.solution.assignment[m.id])]
    if spec == "H100":
        assert len(cm.kernels) == 1 and len(split) == 2
        (k,) = cm.kernels
        assert k.plan.total_bytes + geometry.reduce_part_bytes(512) <= geometry.SMEM_LIMIT
        assert k.fn.workspace_bytes == 0
    else:
        assert not split and len(cm.kernels) == 2


@pytest.mark.parametrize("name", list(CASES))
def test_h100_plans_agree_with_the_jax_package(name):
    """NMT and the Figure-3 attention at small width under H100 (row-split
    dots) through the plain kernels, against the JAX package's
    ``reference_execute`` and ``jax.jit`` of the same function."""
    build, jnp_fn = CASES[name]
    ref_module = build()
    feeds = random_feeds(ref_module, np.random.RandomState(0))
    port = compile_module(module_from_reference(ref_module), StitchOptions(device_spec=H100),
                          device="cpu")
    assert any(is_row_split_dot(m, k.solution.assignment[m.id])
               for k in port.kernels if k.solution is not None for m in k.fusion.members)
    got = port(feeds)
    (key,) = got
    want = ref_execute(ref_module, feeds)
    _close(got[key].numpy(), np.asarray(want[key]), f"{name} vs reference_execute")
    jitted = jax.jit(jnp_fn)(*[jnp.asarray(feeds[p.name]) for p in ref_module.parameters])
    _close(got[key].numpy(), np.asarray(jitted), f"{name} vs jax.jit")


def test_stitch_of_the_attention_agrees_with_jax_under_h100():
    fn, args = _granite_cases(t=64, d=96, h=3, hd=16, ff=32)["fig3_attention"]
    got = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu")(*args)
    _close(got.numpy(), np.asarray(jax.jit(_fig3_jnp)(*args)), "stitch vs jax.jit")
    _close(got.numpy(), fig3_attention(*[torch.as_tensor(a) for a in args]).numpy(), "vs plain")


def test_a_stitched_kernel_stages_its_dot():
    """NMT's fusion cut into two phases under H100 (the scores and their
    softmax, then the second dot and the tanh): one cooperative kernel whose
    second phase stages its dot, its plain version the reference's."""
    ref_module = ALL_GRAPHS["NMT"]()
    compiled = compile_module(module_from_reference(ref_module), StitchOptions(device_spec=H100),
                              device="cpu")
    (k,) = compiled.kernels
    members = list(k.fusion.members)
    second = members.index([m for m in members if m.opcode == "dot"][-1])
    cut = [members[:second], members[second:]]
    phases = []
    for ms in cut:
        ids = {m.id for m in ms}
        roots = [m for m in ms if not m.users or any(u.id not in ids for u in m.users)]
        sol = resolve_schedules(ms, roots, {r.id: Sched("chunked", 1, 8, ROW) for r in roots},
                                1 << 30, H100)
        phases.append(PhaseSolution(ms, roots, sol))
    ids0 = {m.id for m in cut[0]}
    st = StitchedSolution(phases, [m for m in cut[0] if any(u.id not in ids0 for u in m.users)])
    fusion = FusedComputation(members, name="nmt2")
    kernel = codegen.emit_stitched_fusion(fusion, st, plan_stitched_memory(
        st, default_vmem_limit(H100), H100))
    src = kernel.fn.source
    assert src.count("sx_grid_sync();") == 1 and "staged in" in src.splitlines()[0]
    feeds = random_feeds(ref_module, np.random.RandomState(0))
    args = [torch.as_tensor(feeds[i.name]) for i in fusion.inputs]
    (got,) = kernel.fn(*args)
    (key,) = ref_execute(ref_module, feeds)
    _close(got.numpy(), np.asarray(ref_execute(ref_module, feeds)[key]), "stitched vs reference")


def test_the_gpu_model_prices_the_staged_dot():
    """Under H100: a staged dot reads a composed lhs once per column tile
    and its rhs once per row tile; a staged rhs composed from a transpose
    is not charged at a sector a lane; a row-split dot's rhs is charged
    once per block at the L2's rate."""
    fn, args = _granite_cases()["fig3_attention"]
    cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
    (k,) = cm.kernels
    model = LatencyModel(H100)
    members, roots, sol, plan = k.fusion.members, k.fusion.roots, k.solution, k.plan
    tilings = geometry.fusion_launch(members, roots, sol, plan).tilings
    staged = model.fusion_time(members, roots, sol, plan)
    assert model.recompute_s(members, plan, tilings, sol.assignment) < model.recompute_s(
        members, plan, {}, sol.assignment)
    l2 = model.l2_read_bytes(members, sol, tilings)
    qk, pv = [m for m in members if m.opcode == "dot"]
    per_head = 512 * 64 * 4
    assert l2 == sum(sol.blocks * (chunk_rows // tilings[d.id].bm) * per_head
                     for d, chunk_rows in ((qk, 512 // 8), (pv, 512 // 8)))
    with pytest.MonkeyPatch.context() as mp:
        # every dot on the register-tile loop: no staging is offered
        mp.setattr(geometry, "staged_dot_tiling", lambda *a, **k: None)
        loop = model.fusion_time(members, roots, sol, plan)
    assert staged < loop
