"""The port's compiled graphs and kernels against the reference's.

On the CPU the port runs every kernel's plain version (the block
interpreter); the reference runs its Pallas kernels in interpret mode.
Outputs agree at rtol/atol 2e-5, the reference suite's own tolerance
(``tests/conftest.py``).  The CUDA source is checked as text here; it is
built and run against the plain versions on the card by ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs import ALL_GRAPHS, random_feeds
from repro.core import StitchOptions as RefOptions
from repro.core import compile_module as ref_compile
from repro.core import reference_execute as ref_execute
from repro.core import trace as ref_trace
from repro_torch.core import StitchOptions, codegen, compile_module, cuda_build, geometry
from repro_torch.core.interop import module_from_reference
from repro_torch.core.schedule import chunk_shape

TOL = 2e-5
# Speech normalises each (utterance, filter) column by rsqrt(var + 1e-5).
# Where every frame of a column is clamped at log(1e-6) the column is
# constant, its true centred value is 0, and what each package computes is
# the roundoff of a 50-term mean (1-2 ulp of 13.8) times 316; JAX, torch and
# a sequential sum round that mean differently.  Those outputs are held at
# this bound, every other output at TOL.
DEGENERATE_TOL = 1e-3


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=tol, atol=tol, err_msg=what,
    )


def _degenerate_speech_outputs(feeds):
    """Mask of Speech outputs (B, 2F) fed by a constant normalised column."""
    x, w = feeds["frames"], feeds["mel"]
    B, T, F = x.shape
    mel = ((x * x).reshape(B * T, F) @ w).reshape(B, T, F)
    const = (mel < 1e-6).all(axis=1)                        # (B, F)
    return np.concatenate([const, const], axis=1)


@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_compiled_graph_matches_reference(name):
    ref_module = ALL_GRAPHS[name]()
    feeds = random_feeds(ref_module, np.random.RandomState(0))
    port = compile_module(module_from_reference(ref_module), device="cpu")
    got = port(feeds)
    want_compiled = ref_compile(ref_module, RefOptions())(feeds)
    want_oracle = ref_execute(ref_module, feeds)
    assert got.keys() == want_oracle.keys() == want_compiled.keys()
    for k in want_oracle:
        assert got[k].device.type == "cpu"
        for want, what in ((want_compiled[k], "repro compile_module"),
                           (want_oracle[k], "repro reference_execute")):
            g, want = got[k].numpy(), np.asarray(want)
            if name == "Speech":
                bad = _degenerate_speech_outputs(feeds)
                assert 0 < bad.sum() < bad.size / 10
                _close(g[bad], want[bad], f"{name}:{k} vs {what}", DEGENERATE_TOL)
                g, want = g[~bad], want[~bad]
            _close(g, want, f"{name}:{k} vs {what}")


@pytest.mark.parametrize("name", ["StitchPipe", "NMT"])
def test_plain_kernel_matches_reference_kernel(name, rng):
    ref_module = ALL_GRAPHS[name]()
    ref = ref_compile(ref_module, RefOptions())
    port = compile_module(module_from_reference(ref_module), device="cpu")
    (fname, ref_kernel), = ref.executable.kernels.items()
    port_kernel = port.executable.kernels[fname]
    assert port_kernel.fn.emitter == ("emit_stitched_fusion" if name == "StitchPipe" else "emit_fusion")
    args = [rng.uniform(-1, 1, i.shape).astype(np.float32) for i in ref_kernel.inputs]
    want = ref_kernel(*[jnp.asarray(a) for a in args])
    got = port_kernel.fn.plain(*[torch.as_tensor(a) for a in args], device=torch.device("cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        _close(g.numpy(), w, f"{name}:{fname}")
    assert port_kernel.fn.launches == 0    # the plain version is no launch


def test_launch_tally_follows_every_program_by_emitter():
    """``KernelProgram.launches_by_emitter`` moves with each program's
    ``launches``: a count taken around a run keeps the launches of programs
    the run made and dropped, and a counter set back (as a capture or a
    timing sets it) takes its launches back out."""
    tally = codegen.KernelProgram.launches_by_emitter
    saved = dict(tally)
    try:
        for emitter in tally:
            tally[emitter] = 0
        for name in ("StitchPipe", "NMT"):
            port = compile_module(module_from_reference(ALL_GRAPHS[name]()), device="cpu")
            (kernel,) = port.kernels
            kernel.fn.launches += 3
            before = kernel.fn.launches
            kernel.fn.launches += 2
            kernel.fn.launches = before
            del port, kernel
        assert tally == {"emit_fusion": 3, "emit_stitched_fusion": 3}
    finally:
        tally.update(saved)


def test_generated_source_has_one_kernel_per_unique_signature():
    module = module_from_reference(ALL_GRAPHS["BiRNN"]())
    port = compile_module(module, device="cpu")
    src = port.cuda_source
    assert port.stats.unique_kernels == 3 < port.stats.stitched_kernels
    assert len(re.findall(r"__global__ void", src)) == port.stats.unique_kernels
    assert len(re.findall(r'extern "C" int \w+_launch\(', src)) == port.stats.unique_kernels
    assert src.startswith('#include "stitch_runtime.cuh"')
    # threads per block follow the plan (``geometry.fusion_launch``), not a constant
    for k in port.kernels:
        threads = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution,
                                         k.plan).threads
        assert f"__launch_bounds__({threads}) {k.fn.symbol}(" in src
    cmd = cuda_build._command("nvcc", cuda_build.BUILD_DIR / "x.cu", cuda_build.BUILD_DIR / "x.so")
    joined = " ".join(cmd[1:])
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-fPIC" in cmd


def _softmax_transpose(b, x, g):
    """tests/test_stitching.py's break module: a row softmax feeding a 2-D
    transpose, a schedule break once (32, 48) passes the replicate limit."""
    scaled = x * b.broadcast(g, x.shape, (1,))
    mx = b.reduce(scaled, (1,), "max")
    e = b.exp(scaled - b.broadcast(mx, x.shape, (0,)))
    s = b.reduce(e, (1,), "sum")
    p = e / b.broadcast(s, x.shape, (0,))
    t = b.transpose(p, (1, 0))
    return b.tanh(t) * 0.5


# stitched compiles: (module, options, plan blocks of each phase)
STITCHED_CASES = {
    "StitchPipe": (lambda: ALL_GRAPHS["StitchPipe"](), {}, [16, 1]),
    "StitchPipe-stitch_max_blocks=1": (lambda: ALL_GRAPHS["StitchPipe"](), {"stitch_max_blocks": 1}, [1, 1]),
    "StitchPipe-stitch_max_blocks=4": (lambda: ALL_GRAPHS["StitchPipe"](), {"stitch_max_blocks": 4}, [4, 1]),
    "StitchPipe-max_blocks=8": (lambda: ALL_GRAPHS["StitchPipe"](), {"max_blocks": 8}, [8, 1]),
    "StitchPipe-max_blocks=64": (lambda: ALL_GRAPHS["StitchPipe"](), {"max_blocks": 64}, [16, 1]),
    "break-32x48": (
        lambda: ref_trace(_softmax_transpose, ("x", (32, 48), jnp.float32), ("g", (48,), jnp.float32)),
        {"max_blocks": 32, "replicate_limit": 1024}, [2, 1]),
}


@pytest.mark.parametrize("case", list(STITCHED_CASES))
def test_stitched_source_loops_over_its_phases(case, rng):
    """The stitched kernel is ONE cooperative launch over the grid: a grid
    barrier between phases, each phase's ALLOC/SHARE slots in shared memory
    (or, past what a block holds, a per-block workspace region) at the
    bytes of the phase's memory plan, INLINE members composed into their
    consumers with no tile written, and the plain version equal to the
    JAX package's stitched Pallas kernel (interpret mode)."""
    build, opts, phase_blocks = STITCHED_CASES[case]
    ref_module = build()
    ref = ref_compile(ref_module, RefOptions(**opts))
    port = compile_module(module_from_reference(ref_module), StitchOptions(**opts), device="cpu")
    (kernel,) = [k for k in port.kernels if k.fn.emitter == "emit_stitched_fusion"]
    assert [p.solution.blocks for p in kernel.stitched.phases] == phase_blocks
    assert kernel.blocks == sum(phase_blocks)
    src = kernel.fn.source
    assert src.count("__global__") == 1
    assert src.count("cudaLaunchCooperativeKernel(") == 1 and "<<<" not in src
    assert src.count("sx_grid_sync();") == kernel.num_phases - 1
    threads = geometry.stitched_threads(kernel.plan)
    assert f"__launch_bounds__({threads}) {kernel.fn.symbol}(" in src
    # the members of each phase that write a tile: its ALLOC/SHARE members
    # but those held in a register (``held_in_registers``)
    written = {r.id for r in kernel.fusion.roots} | set(kernel.plan.interfaces)
    tiles = [geometry._tile_slots(ph.members, pp, geometry.held_in_registers(
                 ph.members, ph.solution.assignment, pp, written))
             for ph, pp in zip(kernel.stitched.phases, kernel.plan.phase_plans, strict=True)]
    smem = 0
    for pk, pplan in enumerate(kernel.plan.phase_plans):
        head = next(line for line in src.splitlines() if line.startswith(f"  // phase {pk}:"))
        _, size = geometry._slot_layout(pplan, set(tiles[pk].values()))
        assert size <= pplan.total_bytes
        if not tiles[pk]:
            assert head.endswith("no slot: a pure map over the grid")
        elif size <= geometry.SMEM_LIMIT:
            assert head.endswith(f"slots {size} bytes in shared memory")
            smem = max(smem, size)
        else:
            assert head.endswith(f"slots {size} bytes in a per-block workspace region")
            blocks = kernel.stitched.phases[pk].solution.blocks
            assert kernel.fn.workspace_bytes >= kernel.plan.interface_bytes + blocks * size
    assert f"dim3({threads}), args, {smem}, " in src
    # a tile is written for the ALLOC/SHARE members that are not held in a
    # register only, one loop each
    label = {m.id: f"m{k}" for k, m in enumerate(kernel.fusion.members)}
    for phase, pplan, tiled in zip(kernel.stitched.phases, kernel.plan.phase_plans, tiles, strict=True):
        for m in phase.members:
            held = pplan.entries[m.id].action in ("ALLOC", "SHARE") and m.id not in tiled
            line = src.split(f"// {label[m.id]} = ")[1].splitlines()[0] if f"// {label[m.id]} = " in src else ""
            assert ("-> slot" in line) == (m.id in tiled)
            assert ("-> held in a register" in line) == (held and m.opcode != "constant")
    writes = re.findall(r"\bp\d+s\d+\[[^\]]*\] = v;", src)
    assert len(writes) == sum(len(t) for t in tiles)
    # the plain version against the JAX package's stitched kernel
    (fname, ref_kernel), = ref.executable.kernels.items()
    assert port.executable.kernels[fname].fn is kernel.fn
    args = [rng.uniform(-1, 1, i.shape).astype(np.float32) for i in ref_kernel.inputs]
    want = ref_kernel(*[jnp.asarray(a) for a in args])
    got = kernel.fn.plain(*[torch.as_tensor(a) for a in args], device=torch.device("cpu"))
    for g, w in zip(got, want, strict=True):
        _close(g.numpy(), w, f"{case}:{fname}")


# single-phase compiles: every graph's emit_fusion kernels, and a softmax
# whose one plan block's slots (263,168 bytes) pass what a block's shared
# memory holds, so they live in a per-block workspace region
FUSION_CASES = {name: (lambda name=name: ALL_GRAPHS[name](), {})
                for name in ALL_GRAPHS if name != "StitchPipe"}
FUSION_CASES["softmax-128x512-max_blocks=1"] = (
    lambda: ref_trace(lambda b, x: b.softmax(x), ("x", (128, 512), jnp.float32)), {"max_blocks": 1})


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_source_reads_its_memory_plan(case):
    """``emit_fusion``'s kernel follows the fusion's ``MemoryPlan``: its
    ALLOC/SHARE members live in the plan's slots, in dynamic shared memory
    at the plan's offsets (past ``SMEM_LIMIT``, in a per-block workspace
    region); INLINE members are composed into their consumers and get no
    loop of their own unless they are outputs; outputs are written straight
    to ``out*``; every reduce is cooperative (warp shuffles, and the whole
    block where a plan block has fewer outputs than warps); members that
    share no value run on CUDA blocks of their own; and the threads of a
    block follow the plan."""
    build, opts = FUSION_CASES[case]
    port = compile_module(module_from_reference(build()), StitchOptions(**opts), device="cpu")
    kernels = [k for k in port.kernels if k.fn.emitter == "emit_fusion"]
    assert kernels
    for k in kernels:
        src, plan = k.fn.source, k.plan
        assert src.count("__global__") == 1 and "cudaLaunchCooperativeKernel" not in src
        launch = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution, plan)
        threads = launch.threads
        assert f"__launch_bounds__({threads}) {k.fn.symbol}(" in src
        roots = {r.id for r in k.fusion.roots}
        held = geometry.held_in_registers(k.fusion.members, k.solution.assignment, plan, roots)
        tiles = geometry._tile_slots(k.fusion.members, plan, held)
        offs, size = geometry._slot_layout(plan, set(tiles.values()))
        assert size <= plan.total_bytes and (held or size == plan.total_bytes)
        head = next(line for line in src.splitlines() if line.startswith("  // phase 0:"))
        groups = [g for g in geometry._independent_groups(k.fusion.members)
                  if any(m.id in tiles or m.id in roots
                         for m in k.fusion.members if m.id in set(g) and m.opcode != "constant")]
        # a staged dot's operand tiles follow the slots in shared memory
        staged = [t.stage_bytes(4) for t in launch.tilings.values() if t is not None]
        if not tiles:
            assert head.endswith("no slot: a pure map over the grid")
            assert ("sx_smem" in src) == bool(staged)
            grid = None
        elif size + geometry.reduce_part_bytes(threads) <= geometry.SMEM_LIMIT:
            assert head.endswith(f"slots {size} bytes in shared memory")
            assert "extern __shared__ __align__(16) unsigned char sx_smem[];" in src
            smem = -(-size // 16) * 16 + max(staged) if staged else size
            assert f"<<<{k.blocks * len(groups)}, {threads}, {smem}, " in src
            assert k.fn.workspace_bytes == 0
            grid = k.blocks * len(groups)
        else:
            assert head.endswith(f"slots {size} bytes in a per-block workspace region")
            assert f"unsigned char* const pr0 = ws + static_cast<size_t>(blockIdx.x) * {size};" in src
            assert f"<<<{k.blocks * len(groups)}, {threads}, {max(staged, default=0)}, " in src
            assert k.fn.workspace_bytes == size * k.blocks * len(groups)
            grid = k.blocks * len(groups)
        if grid is not None and len(groups) > 1:
            assert f"{len(groups)} independent member groups a plan block" in head
        assert set(offs) == set(tiles.values())
        for slot, off in offs.items():
            base = "sx_smem" if "sx_smem[]" in src else "pr0"
            assert f"p0s{slot} = reinterpret_cast<float*>({base} + {off});" in src
        label = {m.id: f"m{j}" for j, m in enumerate(k.fusion.members)}
        comments = {line.split(" = ")[0].strip().removeprefix("// "): line
                    for line in src.splitlines() if line.strip().startswith("// m")}
        for m in k.fusion.members:
            kept = m.id in tiles
            line = comments.get(label[m.id])
            # a loop for each member that writes a slot or an output, no
            # other; a comment names each member held in a register
            assert (line is not None) == (kept or m.id in roots or m.id in held), (case, m.name)
            assert (line is not None and "-> slot p0s" in line) == kept, (case, m.name)
            assert (line is not None and "-> held in a register" in line) == (m.id in held)
            if m.opcode == "reduce" and line is not None:
                body = src.split(line)[1].split("// m")[0]
                assert "sx_warp_allreduce(acc, " in body
                outs = codegen._prod(chunk_shape(m.shape, k.solution.assignment[m.id]))
                if tiles and 2 * outs <= threads // 32:
                    assert f"{threads // 32 // outs} warps an output" in body
        # INLINE and held members write no tile: the only slot writes are kept members'
        for w in re.findall(r"\bp0s(\d+)\[[^\]]*\] = ", src):
            assert int(w) in offs
    if case == "ReduceTowers":
        (k,) = kernels
        assert "6 independent member groups a plan block" in k.fn.source
        assert k.fn.source.count("4 warps an output") == 6


# ------------------------------------------- members held in registers
def _silu_mul(a, b):
    import torch.nn.functional as F

    return F.silu(a) * b


# bf16 silu(a) * b: the captured graph converts a to f32 and reads it twice
# (x and sigmoid(x)), so the plan gives the convert a slot; every reader
# reads it at the element it was written, so the kernel holds it in a
# register.  (512, 3456) is qwen2.5-14b's MLP width over 512 tokens on
# each of four ranks, (512, 13824) the whole of it.
SILU_SHAPES = [(4, 64), (512, 3456), (512, 13824)]


@pytest.mark.parametrize("shape", SILU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_silu_mul_is_a_pure_map_over_the_grid(shape):
    import repro_torch

    rng = np.random.RandomState(0)
    a, b = (torch.as_tensor(rng.uniform(-4, 4, shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    fn = repro_torch.stitch(_silu_mul, device="cpu")
    got = fn(a, b)
    (k,) = fn._last.compiled.kernels
    assert k.fn.emitter == "emit_fusion"
    plan, src = k.plan, k.fn.source
    (slot,) = [e for e in plan.entries.values() if e.action in ("ALLOC", "SHARE")]
    assert plan.total_bytes == slot.nbytes > 0              # the plan is unchanged
    assert fn._last.compiled.stats.reports[0].scratch_bytes == plan.total_bytes
    held = geometry.held_in_registers(k.fusion.members, k.solution.assignment, plan,
                                     {r.id for r in k.fusion.roots})
    assert len(held) == 1
    assert "-> slot" not in src and "-> held in a register" in src
    assert "no slot: a pure map over the grid" in src and "__syncthreads" not in src
    assert k.fn.workspace_bytes == 0 and "sx_smem" not in src
    threads = geometry.fusion_launch(k.fusion.members, k.fusion.roots, k.solution, plan).threads
    grid = -(-int(np.prod(shape)) // threads)
    assert f"<<<{grid}, {threads}, 0, " in src
    # the register is computed once per element and read at both uses
    (reg,) = re.findall(r"const float (rm\d+) = ", src)
    assert src.count(reg) == 3
    if shape == (512, 3456):
        assert (grid, threads, k.blocks) == (3456, 512, 16)
    if shape == (512, 13824):
        assert (grid, threads, k.blocks) == (13824, 512, 32)
    # the plain version: torch's own bf16 silu and mul, bit for bit
    assert torch.equal(got, _silu_mul(a, b))


def _gated_mlp(x, w_gate, w_up, w_down):
    import torch.nn.functional as F

    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def test_bf16_gated_mlp_silu_mul_is_a_pure_map_over_the_grid():
    """The MLP's fusion of silu x mul, whose output the last product reads
    outside the kernel, holds the convert in a register too, at qwen2.5-14b's
    MLP width on one of four ranks (3456 columns), the model dim cut to 64."""
    import repro_torch

    rng = np.random.RandomState(2)
    shapes = [(512, 64), (64, 3456), (64, 3456), (3456, 64)]
    args = [torch.as_tensor(rng.uniform(-1, 1, s).astype(np.float32) / s[0] ** 0.5).to(torch.bfloat16)
            for s in shapes]
    fn = repro_torch.stitch(_gated_mlp, device="cpu")
    got = fn(*args)
    (k,) = fn._last.compiled.kernels
    src = k.fn.source
    assert k.fn.emitter == "emit_fusion" and k.blocks == 16
    assert "-> held in a register" in src and "-> slot" not in src
    assert k.fn.workspace_bytes == 0 and "<<<3456, 512, 0, " in src
    torch.testing.assert_close(got, _gated_mlp(*args), rtol=2 ** -7, atol=2 ** -7 * float(got.abs().max()))


def test_bf16_silu_mul_plain_version_matches_reference():
    import jax

    import repro
    import repro_torch

    rng = np.random.RandomState(1)
    a, b = (rng.uniform(-4, 4, (16, 96)).astype(np.float32) for _ in range(2))
    got = repro_torch.stitch(_silu_mul, device="cpu")(
        torch.as_tensor(a).to(torch.bfloat16), torch.as_tensor(b).to(torch.bfloat16))

    def jnp_silu_mul(x, y):   # jax.nn.silu is a jit, which repro.stitch does not lower
        x32 = x.astype(jnp.float32)
        return (x32 * jax.lax.logistic(x32)).astype(jnp.bfloat16) * y

    want = repro.stitch(jnp_silu_mul)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


def _reduced(b, x):
    """An exp read by a row sum and by the divide after it."""
    e = b.exp(x)
    return e / b.broadcast(b.reduce(e, (1,), "sum"), x.shape, (0,))


def _broadcast(b, x, v):
    """A tanh of a row vector read through two broadcasts."""
    t = b.tanh(v)
    return x * b.broadcast(t, x.shape, (1,)) + b.broadcast(t, x.shape, (1,))


# (module, the functions of the members that keep their slot); "retiled"
# is the SHARE case below: its second phase's tanh is read transposed, and
# the add that takes its slot reads it across threads
SLOT_KEEPERS = {
    "retiled": (lambda: _share_transposed_module(), ("tanh", "add")),
    "reduced": (lambda: ref_trace(_reduced, ("x", (32, 64), jnp.float32)), ("exp",)),
    "broadcast": (lambda: ref_trace(_broadcast, ("x", (32, 64), jnp.float32), ("v", (64,), jnp.float32)),
                  ("tanh",)),
}


@pytest.mark.parametrize("case", list(SLOT_KEEPERS))
def test_member_read_at_other_elements_keeps_its_slot(case):
    """A member that a reader re-tiles, reduces or broadcasts is read at
    elements other than its own: it keeps its slot and its loop, and the
    plain version still equals the reference."""
    build, fn_names = SLOT_KEEPERS[case]
    ref_module = build()
    port = compile_module(module_from_reference(ref_module), device="cpu")
    ref = ref_compile(ref_module, RefOptions())
    assert _plan_of(port.stats) == _plan_of(ref.stats)
    kept = []
    for k in port.kernels:
        written = {r.id for r in k.fusion.roots}
        if k.stitched is None:
            phases = [(k.fusion.members, k.solution, k.plan)]
        else:
            written |= set(k.plan.interfaces)
            phases = [(ph.members, ph.solution, pp)
                      for ph, pp in zip(k.stitched.phases, k.plan.phase_plans, strict=True)]
        assert "-> held in a register" not in k.fn.source
        label = {m.id: f"m{j}" for j, m in enumerate(k.fusion.members)}
        for pk, (members, solution, plan) in enumerate(phases):
            assert not geometry.held_in_registers(members, solution.assignment, plan, written)
            for m in members:
                if plan.action(m) in ("ALLOC", "SHARE") and m.opcode == "elementwise":
                    fn = m.attrs["fn"]
                    assert re.search(rf"// {label[m.id]} = elementwise:{fn}\(.* -> slot p{pk}s\d+\n",
                                     k.fn.source)
                    kept.append(fn)
    assert sorted(kept) == sorted(fn_names)
    rng = np.random.RandomState(0)
    feeds = {p.name: rng.uniform(-1, 1, p.shape).astype(np.float32) for p in ref_module.parameters}
    got = port(feeds)
    for want, what in ((ref(feeds), "compile_module"), (ref_execute(ref_module, feeds), "reference_execute")):
        for key in want:
            _close(got[key].numpy(), np.asarray(want[key]), f"{case}:{key} vs {what}")


# ------------------------------------------------- emission faults, repaired
def _concat_module():
    """Two row reduces reshaped to columns, concatenated and exp'd: the
    reference fuses all six instructions into one kernel of 4 plan blocks,
    and each concat piece is a composed reshape that needs statements."""
    from repro.core import GraphBuilder

    b = GraphBuilder("concat_pieces")
    x = b.parameter("x", (64, 128), jnp.float32)
    s, m = b.reduce(x, (1,), "sum"), b.reduce(x, (1,), "max")
    b.exp(b.concat([b.reshape(s, (64, 1)), b.reshape(m, (64, 1))], 1))
    return b.module


def _share_transposed_module():
    """A stitched kernel whose second phase has a SHARE member (the add)
    that inherits the tanh's slot and reads it transposed: other threads'
    elements of the slot it is about to overwrite."""
    from repro.core import GraphBuilder

    b = GraphBuilder("share_transposed")
    x = b.parameter("x", (32, 32), jnp.float32)
    a = b.tanh(b.transpose(b.exp(x), (1, 0)))
    m = b.transpose(a, (1, 0)) + b.neg(a)
    b.exp(m) + m * m
    return b.module


def _plan_of(stats):
    return [(r.num_ops, r.blocks, r.num_phases, r.shared_bytes) for r in stats.reports]


@pytest.mark.parametrize("build", [_concat_module, _share_transposed_module])
def test_emission_faults_compile_to_the_reference_plan(build):
    ref_module = build()
    ref = ref_compile(ref_module, RefOptions())
    port = compile_module(module_from_reference(ref_module), device="cpu")
    assert _plan_of(port.stats) == _plan_of(ref.stats)
    assert port.stats.stitched_kernels == ref.stats.stitched_kernels == 1
    rng = np.random.RandomState(0)
    feeds = {"x": (rng.randn(*ref_module.parameters[0].shape) * 0.1).astype(np.float32)}
    got = port(feeds)
    for want, what in ((ref(feeds), "compile_module"), (ref_execute(ref_module, feeds), "reference_execute")):
        for k in want:
            _close(got[k].numpy(), np.asarray(want[k]), f"{ref_module.name}:{k} vs {what}")


def test_concat_pieces_run_their_statements_on_their_branch_only():
    port = compile_module(module_from_reference(_concat_module()), device="cpu")
    assert _plan_of(port.stats) == [(6, 4, 1, 0)]
    src = port.kernels[0].fn.source
    # one temporary assigned on an if/else chain over the concat axis, each
    # piece's index arithmetic inside its own branch
    branch = re.search(r"float (cat\w*);\n\s*if \((o\d) < 1\) \{\n(.*?)\} else \{\n(.*?)\}\n",
                       src, re.S)
    assert branch, src
    var, _, first, second = branch.groups()
    assert "_rem" in first and "_rem" in second
    assert f"{var} = p0s0[" in first and f"{var} = p0s1[" in second
    assert f"sx_exp({var})" in src


def test_share_member_reading_another_element_writes_through_a_stage():
    port = compile_module(module_from_reference(_share_transposed_module()), device="cpu")
    (kernel,) = port.kernels
    plan = kernel.plan.phase_plans[1]
    shares = [e for e in plan.entries.values() if e.action == "SHARE"]
    assert len(shares) == 1
    src = kernel.fn.source
    # the add writes the staging region, then after a barrier copies it in
    stage = re.search(r"reinterpret_cast<float\*>\(sx_stage\)\[(\w+) \* 32 \+ (\w+)\] = v;", src)
    assert stage and "sx_stage = ws + " in src
    copy = src.index("p1s0[i] = reinterpret_cast<const float*>(sx_stage)[i];")
    assert src.rindex("__syncthreads();", 0, copy) > stage.end()
    # the workspace holds the stage: one tile of 4096 bytes a block
    assert kernel.fn.workspace_bytes >= 4096


_FAKE_NVCC = '''#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
cu = args[-1]
for _ in range(20):                       # read it again and again: a rewrite shows
    text = open(cu).read()
    if not text.endswith("// end of source\\n"):
        sys.exit("half-written source: %d bytes" % len(text))
    time.sleep(0.005)
open(out, "w").write(text)
'''

_BUILDER = '''
import sys
from pathlib import Path
sys.path.insert(0, {src!r})
from repro_torch.core import cuda_build as cb
cb.BUILD_DIR = Path({build!r})
source = open({source!r}).read()
cb.build_all([source])
assert open(cb.library_path(source)).read() == source
'''


def test_concurrent_builds_of_one_source_see_a_whole_file(tmp_path):
    """Ranks that build the same kernel at once: each nvcc reads the whole
    ``.cu``, never one that another process is writing (the source goes to
    a file of its own and is renamed into place)."""
    import os
    import subprocess
    import sys

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    source = tmp_path / "k.cu"
    source.write_text("".join(f"// line {i:07d} of a large source\n" for i in range(200_000))
                      + "// end of source\n")
    src_root = str(cuda_build.CSRC.parents[1])
    script = _BUILDER.format(src=src_root, build=str(tmp_path / "build"), source=str(source))
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    errors = [p.communicate(timeout=120)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], errors
