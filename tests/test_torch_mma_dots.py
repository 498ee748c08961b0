"""Staged 16-bit dots on the tensor cores.

A staged dot whose operands are both bf16, or both f16, and whose depth is
a multiple of 16 runs on the tensor cores (``geometry.dot_tiling`` gives its
``DotTiling`` the warps that split the tile; ``codegen._Phase
.mma_dot_loop`` writes it out): its operands are staged in their own
2-byte type, each warp reads them with ``ldmatrix.x4.trans`` and multiplies
with ``mma.sync`` m16n8k16 into f32 sums, and an output stored whole takes
two neighbouring columns a store.  Every product of two 16-bit values is
exact in f32, so only the order of the sums differs from the FMA loop's.
Every other dot keeps the FMA loop, and every f32 kernel keeps its text
(``tests/test_torch_index64.py`` pins the benchmark's cells).

Plans and text here, on meta tensors and small graphs; the ``card`` tests
run the generated kernels against their plain versions on the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_mma_dots.py``.
"""
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import stitch, tracing
from repro_torch.core import StitchOptions, codegen, cuda_build, geometry
from repro_torch.core.fusion import FusedComputation
from repro_torch.core.ir import BFLOAT16, GraphBuilder
from repro_torch.core.latency import H100
from repro_torch.core.memory import plan_memory
from repro_torch.core.pipeline import default_vmem_limit
from repro_torch.core.schedule import ROW, Sched, resolve_schedules

BF16_CELL = "granite-moe-3b-a800m.attn-bf16.prefill-4k"
F32_CELL = "granite-moe-3b-a800m.attn.prefill-4k"
#: the bf16 layer's plan under H100, as the FMA loops had it: each kernel's
#: (emitter, members, plan blocks, CUDA blocks (a cooperative launch's
#: most), threads); only the two dot kernels' text differs
BF16_PLAN = [
    ("emit_fusion", 3, 1, 49152, 512),
    ("emit_fusion", 4, 1, 49152, 512),
    ("emit_fusion", 11, 512, 512, 512),
    ("emit_fusion", 26, 384, 384, 512),
    ("emit_stitched_fusion", 4, 6, 65536, 128),
    ("emit_stitched_fusion", 37, 12, 393216, 128),
]
#: the bf16 layer's two dot kernels: each dot's loop, as its header names it
BF16_DOTS = [
    "m25 staged in 256 x 64 tiles on the tensor cores, 8 x 2 warps of 32 x 32, k steps of 16",
    "m36 staged in 128 x 32 tiles on the tensor cores, 4 x 1 warps of 32 x 32, k steps of 64",
]
HEADER = re.compile(r"(\d+) plan blocks(?: in all)?, (?:one launch of|one cooperative launch of "
                    r"up to) (\d+) blocks of (\d+) threads")


def _cell(workload):
    """The benchmark cell's layer compiled under H100 on meta tensors, and
    how far the compile moved ``codegen.mma_dots``."""
    from stitchbench import harness

    cell = harness.load_cell(workload)
    s = cell.shape
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[s["dtype"]]

    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    fn = cell.program.build(cell.config, cell.batch, cell.seq)
    args = [meta(cell.batch * cell.seq, s["d"])]
    args += [meta(*shape) for shape in cell.program.weight_shapes(s).values()]
    args += [meta(cell.seq, s["head_dim"])] * 2
    before = tracing.snapshot().counters.get("codegen.mma_dots", 0)
    cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
    return cm, tracing.snapshot().counters.get("codegen.mma_dots", 0) - before


@pytest.fixture(scope="module")
def bf16_layer():
    return _cell(BF16_CELL)


def _dots(kernel):
    """The loops a kernel's header names for its dots."""
    head = kernel.fn.source.splitlines()[0]
    return head.split("; dots: ")[1].split("; ") if "; dots: " in head else []


def test_the_bf16_layers_dots_run_on_the_tensor_cores(bf16_layer):
    cm, _ = bf16_layer
    dots = [k for k in cm.kernels if _dots(k)]
    assert sorted(d for k in dots for d in _dots(k)) == BF16_DOTS
    for k in dots:
        src = k.fn.source
        # both dots' lhs and q kT's rhs are contiguous along k: staged k-major
        assert "sx_mma_16816<__nv_bfloat16>(acc[" in src and "sx_ldmatrix_x4(fa[0], " in src
        assert "sx_fma(" not in src
        # staged in bf16, the scores and p @ v written two columns a store
        assert "__nv_bfloat16* const sa = " in src and "__nv_bfloat16* const sb = " in src
        assert "*reinterpret_cast<__nv_bfloat162*>(&out0[" in src
    # q kT's lhs, q after RoPE, is read plainly from a staged interface:
    # staged 16 bytes, 8 neighbouring k, at a time, its whole depth of 64
    # in one step; p @ v's in steps of 16, the next held in registers, two
    # blocks of 512 threads an SM
    (qk,) = [k for k in dots if "m36 staged" in k.fn.source.splitlines()[0]]
    assert re.search(r"\*reinterpret_cast<uint4\*>\(&sa\[w \* 72 \+ kk\]\) = "
                     r"\*reinterpret_cast<const uint4\*>\(&s\d+\[", qk.fn.source)
    assert "for (int k0 = 0; k0 < 64; k0 += 64)" in qk.fn.source and "__launch_bounds__(128)" in qk.fn.source
    (pv,) = [k for k in dots if "m25 staged" in k.fn.source.splitlines()[0]]
    assert "pa[ek] = " in pv.fn.source and "__launch_bounds__(512, 2)" in pv.fn.source
    # a value widened and rounded back is not rounded again where it is staged
    assert "__float2bfloat16_rn(__bfloat162float(" not in "".join(
        line for k in dots for line in k.fn.source.splitlines()
        if re.match(r"\s+(pa\[ek\]|pb\[ek\]|sa\[|sb\[)", line))
    # the instruction itself is the runtime header's, which every source includes
    unit = codegen.assemble_source([k.fn for k in dots])
    headers = "".join(h.read_text() for h in cuda_build.included_headers(unit))
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in headers
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in headers


def test_the_bf16_layers_plan_is_unchanged(bf16_layer):
    cm, _ = bf16_layer
    plan = []
    for k in cm.kernels:
        blocks, grid, threads = HEADER.search(k.fn.source.splitlines()[0]).groups()
        assert int(blocks) == k.blocks
        plan.append((k.fn.emitter, len(k.fusion.members), k.blocks, int(grid), int(threads)))
    assert sorted(plan) == BF16_PLAN


def _launches(kernel):
    """A compiled kernel's launch records, one a phase."""
    if kernel.fn.emitter == "emit_stitched_fusion":
        return geometry.stitched_launch(kernel.stitched, kernel.plan)
    return (geometry.fusion_launch(kernel.fusion.members, kernel.fusion.roots, kernel.solution,
                                   kernel.plan),)


@pytest.mark.parametrize("workload", [BF16_CELL, F32_CELL])
def test_the_launch_record_decides_the_blocks_an_sm_the_kernel_asks(workload, bf16_layer):
    """Two blocks an SM only for p @ v: 512 threads a block and a dot on the
    tensor cores; q kT's blocks have 128 threads, and no f32 kernel asks."""
    cm, _ = bf16_layer if workload == BF16_CELL else _cell(workload)
    two = 0
    for k in cm.kernels:
        launches = _launches(k)
        (blocks,) = {launch.blocks_per_sm for launch in launches}
        threads = launches[0].threads
        mma = any("tensor cores" in d for d in _dots(k))
        assert blocks == (2 if mma and threads == 512 else 1)
        bounds = f"{threads}, 2" if blocks == 2 else f"{threads}"
        assert f"__global__ void __launch_bounds__({bounds}) stitch_" in k.fn.source
        two += blocks == 2
    assert two == (1 if workload == BF16_CELL else 0)


def test_mma_dots_are_counted_in_the_bf16_layer_only(bf16_layer):
    _, mma = bf16_layer
    assert mma == 2
    cm, mma = _cell(F32_CELL)
    assert mma == 0 and all("tensor cores" not in d for k in cm.kernels for d in _dots(k))


#: each operand as stored: n, its product's own layout; t, transposed (the
#: lhs stored (4, k, 256), the rhs (4, 256, k)): a plain lhs and a
#: transposed rhs are contiguous along k, and staged k-major
#: (``DotTiling.kmajor``, read by ``ldmatrix``), the others by
#: ``ldmatrix.trans``
LAYOUTS = ("nn", "tn", "nt", "tt")


def _shapes(k, layout):
    return ((4, k, 256) if layout[0] == "t" else (4, 256, k),
            (4, 256, k) if layout[1] == "t" else (4, k, 256))


def _batched_dot(dtype, k, layout="nn"):
    """(4, 256, k) @ (4, k, 256) of ``dtype`` as one ``emit_fusion`` kernel
    under H100, each operand stored as ``layout`` says and a transpose
    composed into the dot's read, in one plan block: a pure map over the
    grid of its tiles."""
    b = GraphBuilder("mm")
    (ls, rs) = _shapes(k, layout)
    lhs, rhs = b.parameter("a", ls, dtype), b.parameter("b", rs, dtype)
    b.dot(b.transpose(lhs, (0, 2, 1)) if layout[0] == "t" else lhs,
          b.transpose(rhs, (0, 2, 1)) if layout[1] == "t" else rhs, fusable=True)
    members = [i for i in b.module.instructions if i.opcode != "parameter"]
    fusion = FusedComputation(members, name="mm")
    sol = resolve_schedules(members, fusion.roots, {r.id: Sched("chunked", 0, 1, ROW)
                                                    for r in fusion.roots}, 1 << 40, spec=H100)
    return codegen.emit_fusion(fusion, sol, plan_memory(members, fusion.roots, sol,
                                                        default_vmem_limit(H100), H100))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_an_operand_contiguous_along_k_is_staged_k_major(layout):
    kernel = _batched_dot(BFLOAT16, 64, layout)
    src = kernel.fn.source
    (loop,) = _dots(kernel)
    assert "on the tensor cores" in loop
    lhs_km, rhs_km = layout[0] == "n", layout[1] == "t"
    assert ("sx_ldmatrix_x4(fa[0], sa + ra + kk)" in src) == lhs_km
    assert ("sx_ldmatrix_x4_trans(fa[0], sa + ra + kk * " in src) == (not lhs_km)
    assert ("sx_ldmatrix_x4(fb[0], fb[1], sb + rb + kk)" in src) == rhs_km
    assert ("sx_ldmatrix_x4_trans(fb[0], fb[1], sb + rb + kk * " in src) == (not rhs_km)
    assert ("sa[w * 72 + kk] = " in src) == lhs_km and ("sb[w * 72 + kk] = " in src) == rhs_km
    # kernel inputs need not be 16-byte aligned: staged element by element
    assert "uint4" not in src


def test_an_f16_dot_takes_the_f16_form():
    kernel = _batched_dot(np.float16, 64)
    (loop,) = _dots(kernel)
    assert "on the tensor cores" in loop
    src = kernel.fn.source
    assert "sx_mma_16816<__half>(acc[" in src and "__half* const sa = " in src
    assert "*reinterpret_cast<__half2*>(&out0[" in src and "__floats2half2_rn(acc[0][0], acc[0][1])" in src
    unit = codegen.assemble_source([kernel.fn])
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in "".join(
        h.read_text() for h in cuda_build.included_headers(unit))


@pytest.mark.parametrize("dtype", [BFLOAT16, np.float16], ids=["bf16", "f16"])
def test_a_16_bit_dot_of_a_depth_not_a_multiple_of_16_keeps_the_fma_loop(dtype):
    kernel = _batched_dot(dtype, 24)
    (loop,) = _dots(kernel)
    assert "tensor cores" not in loop and "staged in" in loop
    assert "sx_fma(" in kernel.fn.source and "sx_mma_16816" not in kernel.fn.source


@pytest.mark.parametrize("dtypes, kind", [
    ((BFLOAT16, BFLOAT16), "bf16"), ((np.float16, np.float16), "f16"),
    ((BFLOAT16, np.float16), None), ((np.float32, np.float32), None),
    ((np.float32, BFLOAT16), None),
], ids=["bf16", "f16", "mixed", "f32", "f32-bf16"])
def test_only_operands_of_one_16_bit_type_take_the_tensor_cores(dtypes, kind):
    dot = SimpleNamespace(operands=[SimpleNamespace(dtype=d) for d in dtypes])
    assert geometry.mma_type(dot) == kind


#: (output chunk rows, columns, depth, threads) of staged dots
TILINGS = [(256, 64, 4096, 512), (4096, 4096, 64, 128), (1024, 64, 1024, 512), (16, 1024, 64, 512),
           (32, 64, 4096, 128), (64, 256, 64, 512), (48, 96, 32, 256), (16, 16, 16, 128)]


@pytest.mark.parametrize("rows, cols, depth, threads", TILINGS)
def test_tensor_core_tilings_split_into_m16_n8_pieces_across_the_warps(rows, cols, depth, threads):
    from repro_torch.core.schedule import REPLICATED

    b = GraphBuilder("mm")
    b.dot(b.parameter("a", (rows, depth), BFLOAT16), b.parameter("b", (depth, cols), BFLOAT16),
          fusable=True)
    dot = b.module.instructions[-1]
    assert dot.opcode == "dot" and tuple(dot.shape) == (rows, cols)
    t = geometry.dot_tiling(dot, REPLICATED, threads, geometry.SMEM_LIMIT)
    assert t is not None and t.warps, t
    wm, wn = t.warp_tile
    assert t.warps[0] * wm == t.bm and t.warps[1] * wn == t.bn
    assert wm % 16 == 0 and wn % 16 == 0                 # m16 pieces by pairs of n8 pieces
    assert t.warps[0] * t.warps[1] * 32 <= threads
    assert wm * wn // 32 <= geometry.DOT_MMA_ACC         # f32 sums a thread
    assert t.bk % 16 == 0 and depth % t.bk == 0
    assert t.stage_bytes(2) <= geometry.SMEM_LIMIT
    # ldmatrix rows: 16-byte aligned, an odd count of 16-byte words
    for n in (t.bm, t.bn):
        assert (n + t.pad) * 2 % 16 == 0 and (n + t.pad) * 2 // 16 % 2 == 1
    # the FMA loop's ranking: the same tile an f32 dot of this shape takes
    f = GraphBuilder("mm32")
    f.dot(f.parameter("a", (rows, depth), np.float32), f.parameter("b", (depth, cols), np.float32),
          fusable=True)
    t32 = geometry.dot_tiling(f.module.instructions[-1], REPLICATED, threads, geometry.SMEM_LIMIT)
    if t32.bm % 16 == 0 and t32.bn % 16 == 0:
        assert (t.bm, t.bn) == (t32.bm, t32.bn)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: one rounding step of each type: the dot's sums differ from the plain
#: version's (cuBLAS) only in order, since every product of two 16-bit
#: values is exact in f32, so an output may round to the neighbouring value
#: of its type (one ulp: at most 2^-7 of it in bf16, 2^-10 in f16); a
#: composed operand's exp may round to its neighbour too (the kernel's expf
#: against torch's), which moves an output by one such step of the largest
#: output at most
STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
#: (tokens, head_dim) of the benchmark's bf16 attention at small token
#: counts: its plans take every launch path of a staged dot (a stitched
#: kernel of 512 threads with both dots at 256, one kernel with both at 512,
#: the chain and p @ v in a kernel with slots and the RoPE'd q kT in a
#: stitched pure-map phase at 1024) and, at head_dim 128, q kT's lhs staged
#: 16 bytes at a time over several k steps
CARD_CASES = ((256, 64), (512, 64), (1024, 64), (1024, 128))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _recorded(cm, feeds):
    """Run ``cm`` once on ``feeds``, keeping each generated kernel's inputs."""
    inputs = {}
    for k in cm.executable.kernels.values():
        def record(*a, device, out=None, _fn=k.fn, _launch=k.fn.launch):
            inputs.setdefault(id(_fn), (_fn, [t.clone() for t in a]))
            return _launch(*a, device=device) if out is None else _launch(*a, device=device, out=out)
        k.fn.launch = record
    try:
        out = cm(feeds)
    finally:
        for k in cm.executable.kernels.values():
            k.fn.__dict__.pop("launch", None)
    return list(out.values()), list(inputs.values())


def _assert_steps(got, want, dtype, what):
    step = STEP[dtype]
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=step, atol=step * scale, msg=what)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("seq, head_dim", CARD_CASES)
def test_the_attentions_dots_on_the_card_equal_their_plain_versions(card, seq, head_dim, dtype):
    """The benchmark's bf16 attention (RMSNorm, q/k/v, RoPE, causal
    softmax, p @ v, the output projection) at 1 x ``seq`` tokens, its 1536
    wide heads of ``head_dim``: every dot kernel takes the tensor cores,
    and every generated kernel equals its plain version on the same inputs
    within ``STEP``."""
    from stitchbench.programs import decoder_layer as dl

    cfg = json.loads(Path("stitchbench/configs/granite-moe-3b-a800m.attn-bf16.json").read_text())
    cfg.update(head_dim=head_dim, num_attention_heads=1536 // head_dim,
               num_key_value_heads=512 // head_dim)
    fn = dl.build(cfg, 1, seq)
    layers, (cos, sin), (x,) = dl.make_inputs(cfg, 1, seq, 34, 1, card)
    args = [t.to(dtype) for t in (x, *layers[0].values(), cos, sin)]
    lowered = stitch(fn, options=StitchOptions(device_spec=H100, jit_replay=False)).lower(*args)
    cm = lowered.compile()
    dots = [d for k in cm.kernels for d in _dots(k)]
    assert len(dots) == 2 and all("on the tensor cores" in d for d in dots), dots
    got, recorded = _recorded(cm, dict(zip(lowered.param_names, args, strict=True)))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for fn_, a in recorded:
        for g, w in zip(fn_.launch(*a, device=card), fn_.plain(*a, device=card), strict=True):
            _assert_steps(g, w, dtype, f"{fn_.name} at seq {seq}")


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_a_16_bit_dot_on_the_card_is_its_exact_product_rounded_once(card, dtype, layout):
    """(4, 256, 64) @ (4, 64, 256), a pure map over the grid, each operand
    staged k-major or not as it is stored: f32 sums of exact products,
    rounded once, so each output is within half a step of the float64
    product, plus the f32 sums' own rounding."""
    np_dtype = {torch.bfloat16: BFLOAT16, torch.float16: np.float16}[dtype]
    kernel = _batched_dot(np_dtype, 64, layout)
    assert "no slot" in kernel.fn.source
    lib, _ = cuda_build.load(codegen.assemble_source([kernel.fn]))
    kernel.fn.load(lib)
    gen = torch.Generator(device=card).manual_seed(34)
    ls, rs = _shapes(64, layout)
    a = torch.randn(*ls, generator=gen, device=card).to(dtype)
    b = torch.randn(*rs, generator=gen, device=card).to(dtype)
    stored = {"a": a, "b": b}        # the kernel's inputs, in its fusion's order
    (got,) = kernel.fn(*[stored[i.name] for i in kernel.inputs])
    a, b = (a.transpose(1, 2) if layout[0] == "t" else a), (b.transpose(1, 2) if layout[1] == "t" else b)
    exact = a.double() @ b.double()
    bound = STEP[dtype] / 2 * exact.abs() + 64 * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - exact).abs() <= bound).all())
    (plain,) = kernel.fn.plain(*[stored[i.name] for i in kernel.inputs], device=card)
    _assert_steps(got, plain, dtype, "the dot against its plain version")
