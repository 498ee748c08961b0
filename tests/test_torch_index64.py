"""Index width of the generated and the hand-written kernels.

A generated kernel indexes in ``int`` unless a tensor it addresses, or a
loop variable it forms, passes 2^31 - 1 (a grid-stride loop's variable
reaches its count plus the grid's stride): then every loop variable, unravel
remainder, block index and offset is ``long long``
(``codegen._wide``), and a launch past 2^31 - 1 blocks raises
``NotImplementedError`` naming the limit.  Below the limit the emitted
text is the parent's byte for byte, so every kernel's name (the hash of its
text) is pinned here against the parent's, over the ten graphs under both
specs, the four granite-width functions and ``tests/test_torch_codegen.py``'s
modules.  Only kernels that hold a fused dot differ, by the staged dot loop
(``tests/test_torch_fused_dot.py``).  The hand-written kernels' entry
points refuse sizes their launchers cannot take (``kernels.cuda.check_sizes``).
Plans and text only: nothing here allocates a tensor past the limit.
"""
import re

import numpy as np
import pytest
import torch

import test_torch_codegen as tc
import test_torch_plan_h100 as tp
from graphs import ALL_GRAPHS
from repro_torch import stitch
from repro_torch.core import StitchOptions, codegen, compile_module, trace
from repro_torch.core.codegen import INT_MAX
from repro_torch.core.fusion import FusedComputation, constant_like
from repro_torch.core.interop import module_from_reference
from repro_torch.core.latency import H100, TPU_V5E
from repro_torch.core.memory import plan_stitched_memory
from repro_torch.core.pipeline import default_vmem_limit
from repro_torch.core.schedule import ROW, PhaseSolution, Sched, StitchedSolution, resolve_schedules
from repro_torch.kernels import ops
from repro_torch.kernels.cuda import ROWWISE, HandKernel
from repro_torch.kernels.stitched_softmax import stitched_softmax

WIDE = (65536, 32769)       # 2,147,549,184 elements: past INT_MAX
MID = (40000, 32769)        # 1,310,760,000 elements: under INT_MAX, twice it past
SPECS = {"TPU_V5E": TPU_V5E, "H100": H100}


def _map(b, x):
    return x * 1.5 + 0.25


def _row_sum(b, x):
    return b.reduce(b.exp(x), (1,), "sum")


def _kernel(fn, shape, spec=H100):
    cm = compile_module(trace(fn, ("x", shape, np.float32)),
                        StitchOptions(device_spec=spec, jit_replay=False), device="cpu")
    (k,) = cm.kernels
    return k


def _body(source):
    """The kernel's text: its header, signature and launcher left out."""
    return source.split(") {\n", 1)[1].split('extern "C"')[0]


def _assert_wide(source):
    assert source.splitlines()[0].endswith("64-bit indices and offsets")
    body = _body(source)
    # no 32-bit loop, index or offset: every integer the body declares is
    # 64-bit but the thread's own coordinates within its block and tile
    ints = re.findall(r"\bint (\w+)", body)
    assert set(ints) <= {"w", "p", "ty", "tx", "kk", "e", "ek", "k0", "k"}, ints
    assert "for (int t " not in body and "for (int b " not in body
    for ref in re.findall(r"\b(?:in|out)\d+\[([^\]]*)\]", body):
        for term in _terms(ref):
            if " * " in term:
                assert term.startswith("static_cast<long long>("), ref


def _terms(expr):
    """The terms of a sum, split at its outermost " + "."""
    out, depth, cur = [], 0, ""
    for k, ch in enumerate(expr):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and expr.startswith(" + ", k):
            out.append(cur)
            cur = ""
            continue
        cur += ch
    out.append(cur)
    return [t.strip(" +") for t in out]


@pytest.mark.parametrize("spec", list(SPECS))
def test_map_past_int_max_indexes_in_64_bits(spec):
    k = _kernel(_map, WIDE, SPECS[spec])
    src = k.fn.source
    _assert_wide(src)
    assert "for (long long t = static_cast<long long>(blockIdx.x) * " in src
    assert f"t < {WIDE[0] * WIDE[1]}" in src
    # the same map below the limit is the parent's text: 32-bit
    small = _kernel(_map, (512, 32769), SPECS[spec]).fn.source
    assert "long long" not in small and "64-bit" not in small


def test_map_whose_grid_stride_passes_int_max_indexes_in_64_bits():
    # every tensor is under the limit, but the pure map's grid covers its
    # elements once, so t + gridDim.x * 512 passes INT_MAX in its last step
    n = MID[0] * MID[1]
    assert n < INT_MAX < 2 * n
    src = _kernel(_map, MID).fn.source
    _assert_wide(src)
    assert "t += static_cast<long long>(gridDim.x) * 512" in src


@pytest.mark.parametrize("shape, wide", [((32768, 32768), False), ((32768, 32769), True)])
def test_grid_stride_reach_decides_the_width(shape, wide):
    # 2^30 elements over 2^21 blocks of 512: t reaches 2^30 - 1 + 2^30 =
    # INT_MAX, which int holds; one more column and it does not
    src = _kernel(_map, shape).fn.source
    assert ("64-bit indices and offsets" in src.splitlines()[0]) == wide
    assert ("for (int t = blockIdx.x * 512 + threadIdx.x;" in src) == (not wide)


def test_reduce_past_int_max_indexes_in_64_bits():
    _assert_wide(_kernel(_row_sum, WIDE).fn.source)
    # its input stays under the limit; its loop over 32 lanes an output does not
    shape = (70_000_000, 2)
    assert shape[0] * shape[1] < INT_MAX < 32 * shape[0]
    src = _kernel(lambda b, x: b.reduce(x, (1,), "sum"), shape).fn.source
    _assert_wide(src)
    assert "long long ow = (static_cast<long long>(blockIdx.x) * " in src


def _stitched(shape, phases=2):
    """The map chain x -> x * 1.5 + 0.25 (four times) over ``shape`` cut into
    ``phases`` phases: one stitched kernel through a staged interface."""
    def chain(b, x):
        for _ in range(4):
            x = x * 1.5 + 0.25
        return x

    module = trace(chain, ("x", shape, np.float32), name="chain")
    (fusion,) = compile_module(module, StitchOptions(device_spec=H100, jit_replay=False),
                               device="cpu").executable.plan.fusions
    ops_ = [m for m in fusion.members if not constant_like(m)]
    cut = {m.id: k * phases // len(ops_) for k, m in enumerate(ops_)}
    phase_of = {}
    for m in reversed(fusion.members):
        phase_of[m.id] = cut.get(m.id, min((phase_of[u.id] for u in m.users if u.id in phase_of),
                                           default=0))
    out = []
    for k in range(phases):
        members = [m for m in fusion.members if phase_of[m.id] == k]
        ids = {m.id for m in members}
        roots = [m for m in members if not m.users or any(u.id not in ids for u in m.users)]
        sol = resolve_schedules(members, roots, {r.id: Sched("chunked", 0, 1, ROW) for r in roots},
                                1 << 40)
        out.append(PhaseSolution(members, roots, sol))
    ifaces = [m for m in fusion.members if any(phase_of.get(u.id, -1) > phase_of[m.id]
                                               for u in m.users)]
    st = StitchedSolution(out, ifaces)
    return codegen.emit_stitched_fusion(FusedComputation(list(fusion.members), name="chain"), st,
                                        plan_stitched_memory(st, default_vmem_limit(H100), H100))


def test_stitched_kernel_past_int_max_indexes_in_64_bits():
    k = _stitched(WIDE)
    src = k.fn.source
    assert k.fn.emitter == "emit_stitched_fusion" and src.count("sx_grid_sync();") == 1
    _assert_wide(src)
    # the staged interface: 8.59 GB of workspace, its offset a 64-bit literal
    assert k.fn.workspace_bytes >= 4 * WIDE[0] * WIDE[1]
    small = _stitched((512, 64)).fn.source
    assert "long long" not in small and "64-bit" not in small


def test_stitched_kernel_whose_grid_stride_passes_int_max_indexes_in_64_bits():
    # the cooperative grid is at most the phases' useful blocks, so the
    # reach is counted with that many
    k = _stitched(MID)
    assert k.fn.emitter == "emit_stitched_fusion"
    _assert_wide(k.fn.source)


def test_a_launch_past_the_grid_limit_raises_naming_it():
    # a map over 2^40 elements takes 2^31 blocks of 512 threads
    with pytest.raises(NotImplementedError, match=r"gridDim.x is at most 2\^31 - 1"):
        _kernel(_map, (1 << 20, 1 << 20))


def _reshape_map(b, x):
    return b.reshape(x, (WIDE[1], WIDE[0])) * 1.5


def _reshape_dot(b, x, v):
    return b.dot(b.reshape(b.exp(x), (64, 32768, 1025)), v, fusable=True)


RESHAPES = {
    # a reshape composed into a pure map over 2^31 + 65536 elements
    "map": (_reshape_map, [("x", WIDE, np.float32)]),
    # a reshape a staged dot reads its lhs through: the granite attention's
    # p @ v at 6 x 4096 tokens, whose unravel wrapped past sequence 5
    "staged dot": (_reshape_dot, [("x", (64 * 32768, 1025), np.float32),
                                  ("v", (64, 1025, 64), np.float32)]),
}


@pytest.mark.parametrize("case", list(RESHAPES))
def test_a_reshape_in_a_wide_kernel_unravels_in_64_bits(case):
    fn, specs = RESHAPES[case]
    cm = compile_module(trace(fn, *specs), StitchOptions(device_spec=H100, jit_replay=False),
                        device="cpu")
    (k,) = cm.kernels
    src = k.fn.source
    assert src.splitlines()[0].split(";")[0].endswith("64-bit indices and offsets")
    assert ("staged in" in src.splitlines()[0]) == (case == "staged dot")
    # the reshape's linear index is split in 64 bits, then in int once the
    # quotient left fits one (``codegen._unravel_wide``)
    assert re.findall(r"\bint \w+_rem\b", src) == []
    assert re.search(r"long long p\w*_rem = ", src)
    assert re.search(r"int p\w*_rem32 = static_cast<int>\(p\w*_rem\);", src)


def test_plain_version_of_a_wide_plan_is_the_plans():
    """The plain version does not depend on the index width: the same plan
    at a small size (a wide tensor cannot be allocated here) still equals
    torch."""
    k = _kernel(_map, (64, 33))
    x = torch.rand(64, 33)
    (got,) = k.fn(x)
    assert torch.equal(got, x * 1.5 + 0.25)


# ---------------------------------------------------------------------------
# byte for byte the parent's text below the limit
# ---------------------------------------------------------------------------

#: each case's kernel names (``stitch_`` + the hash of the text) as the
#: parent's emitter gave them (commit 5d3a686)
PARENT = {
    "graph:LR:TPU_V5E": ["stitch_1778a1342accef3d", "stitch_77e97b301ee95625",
                         "stitch_b8d90a2773d115d8", "stitch_eda719dafbdd89df",
                         "stitch_f87e0492faa18ec5"],
    "graph:W2V:TPU_V5E": ["stitch_62d1bb910666144a"],
    "graph:RNN:TPU_V5E": ["stitch_e74eb4be513c0d82", "stitch_f567ceee112d732b"],
    "graph:BiRNN:TPU_V5E": ["stitch_63c73c8925bdfc92", "stitch_a48af63323a636e9",
                            "stitch_f567ceee112d732b"],
    "graph:Speech:TPU_V5E": ["stitch_65b1d9e4de9fe434", "stitch_ba6f7fce598bd61b"],
    "graph:NMT:TPU_V5E": ["stitch_84b7e6d10ffdaa9e"],
    "graph:Stacked:TPU_V5E": ["stitch_063002735015dd64", "stitch_a16892c452dde879",
                              "stitch_f7787421a8e51f85"],
    "graph:ReduceTowers:TPU_V5E": ["stitch_73e56cfc60d5ad8f"],
    "graph:BcastHeavy:TPU_V5E": ["stitch_b9caa7669e911c00"],
    "graph:StitchPipe:TPU_V5E": ["stitch_203c77bc0acc76ec"],
    "model:rmsnorm:TPU_V5E": ["stitch_aef1772c962ecabc"],
    "model:layer_stats:TPU_V5E": ["stitch_b02aed15e0230518"],
    "model:gated_mlp:TPU_V5E": ["stitch_8626778c30445d48"],
    "model:fig3_attention:TPU_V5E": ["stitch_82652b1aaf32989f", "stitch_e76121974a2cc1d8"],
    "graph:LR:H100": ["stitch_1778a1342accef3d", "stitch_77e97b301ee95625",
                      "stitch_b8d90a2773d115d8", "stitch_e81a027d3c0d0ff2",
                      "stitch_f87e0492faa18ec5"],
    "graph:W2V:H100": ["stitch_48cc4b602c1802ce"],
    "graph:RNN:H100": ["stitch_16535c96dccfa135", "stitch_e74eb4be513c0d82"],
    "graph:BiRNN:H100": ["stitch_16535c96dccfa135", "stitch_25f4606712cd3cfc",
                         "stitch_63c73c8925bdfc92"],
    "graph:Speech:H100": ["stitch_9804c23b6bb8b91c", "stitch_ba6f7fce598bd61b"],
    "graph:NMT:H100": ["stitch_bcff8a3c93dc41b4"],
    "graph:Stacked:H100": ["stitch_62eed211f06193cf", "stitch_ea69009b627a6a20",
                           "stitch_f7787421a8e51f85"],
    "graph:ReduceTowers:H100": ["stitch_73e56cfc60d5ad8f"],
    "graph:BcastHeavy:H100": ["stitch_f5d138fa1cd9d511"],
    "graph:StitchPipe:H100": ["stitch_6f038a9503a69d34"],
    "model:rmsnorm:H100": ["stitch_6b1968134612ca32"],
    "model:layer_stats:H100": ["stitch_1936e81bfd0050de"],
    "model:gated_mlp:H100": ["stitch_6cc4ee2095a5e3d2"],
    "model:fig3_attention:H100": ["stitch_0f2a4201c35b9795", "stitch_1973f8683c75c196",
                                  "stitch_2088e5da94776f93", "stitch_25d7fa3b7927f4b3",
                                  "stitch_bef096cabb6bf873"],
    "codegen:stitched:StitchPipe": ["stitch_203c77bc0acc76ec"],
    "codegen:stitched:StitchPipe-stitch_max_blocks=1": ["stitch_51c145bc9f5bdea5"],
    "codegen:stitched:StitchPipe-stitch_max_blocks=4": ["stitch_4b752647ac9e3d49"],
    "codegen:stitched:StitchPipe-max_blocks=8": ["stitch_5633c69124fa1c67"],
    "codegen:stitched:StitchPipe-max_blocks=64": ["stitch_203c77bc0acc76ec"],
    "codegen:stitched:break-32x48": ["stitch_b30252a37ccf3eee"],
    "codegen:fusion:softmax-128x512-max_blocks=1": ["stitch_f1ecb399af4b2f7a"],
    "codegen:slots:retiled": ["stitch_fc377668fb2e1d3f"],
    "codegen:slots:reduced": ["stitch_83701d59e33272e7"],
    "codegen:slots:broadcast": ["stitch_d477c71883575efc"],
    "codegen:concat": ["stitch_2c3d0464588f9af1"],
    "codegen:silu:4x64": ["stitch_1aedfa83b4c9ec17"],
    "codegen:silu:512x3456": ["stitch_3adab846774a3fb6"],
    "codegen:silu:512x13824": ["stitch_c5b869c0174e1594"],
}
#: the cases whose plans hold a fused dot: their dot kernels take the staged
#: loop (and under H100 the row split), so their text is new
DOT_CASES = {"graph:NMT:TPU_V5E", "graph:NMT:H100", "model:fig3_attention:TPU_V5E",
             "model:fig3_attention:H100"}


def _compile_case(name):
    kind, rest = name.split(":", 1)
    if kind in ("graph", "model"):
        what, spec = rest.rsplit(":", 1)
        if kind == "graph":
            return compile_module(module_from_reference(ALL_GRAPHS[what]()),
                                  StitchOptions(device_spec=SPECS[spec]), device="cpu")
        fn, args = tp._granite_cases()[what]
        opts = (StitchOptions(device_spec=H100) if spec == "H100"
                else StitchOptions(device_spec=TPU_V5E, max_blocks=32))
        return stitch(fn, options=opts, device="cpu").lower(*args).compile()
    group, _, case = rest.partition(":")
    if group == "stitched":
        build, opts, _ = tc.STITCHED_CASES[case]
    elif group == "fusion":
        build, opts = tc.FUSION_CASES[case]
    elif group == "slots":
        build, opts = tc.SLOT_KEEPERS[case][0], {}
    elif group == "concat":
        build, opts = tc._concat_module, {}
    else:
        shape = tuple(int(d) for d in case.split("x"))
        a = torch.zeros(shape, dtype=torch.bfloat16)
        return stitch(tc._silu_mul, device="cpu").lower(a, a).compile()
    return compile_module(module_from_reference(build()), StitchOptions(**opts), device="cpu")


@pytest.mark.parametrize("name", list(PARENT))
def test_kernels_below_the_limit_are_the_parents_text(name):
    cm = _compile_case(name)
    names = {k.fn.name for k in cm.kernels}
    dots = {k.fn.name for k in cm.kernels if any(m.opcode == "dot" for m in k.fusion.members)}
    for k in cm.kernels:
        assert "long long t" not in k.fn.source and "64-bit" not in k.fn.source
    if name in DOT_CASES:
        assert dots and all("staged in" in k.fn.source.splitlines()[0] for k in cm.kernels
                            if k.fn.name in dots)
        assert names - dots <= set(PARENT[name])
    else:
        assert not dots
        assert sorted(names) == PARENT[name]


#: each benchmark cell's layer under ``H100`` (its kernel names), compiled here
#: on meta tensors; only kernels past the limit may change, and none does.
#: Since a value computed from indices alone is not held to the replicate
#: limit on the GPU (``schedule.index_values``), each cell's causal softmax
#: (scale, mask, max, exp and sum) is one kernel: granite f32's
#: ``stitch_d2f5eb97b18f7a31``; in bf16 and in Mistral the chain and v's
#: relayout join p @ v (``stitch_74365f6a208c477b``, ``stitch_4153302b9a950c61``).
#: The hybrid cell compiles two plans, its Mamba-2 layer's and its attention
#: layer's: their kernels together (the MLP's and the norms' in both)
CELLS = {
    "granite-moe-3b-a800m.attn.prefill-4k": [
        "stitch_0e79b6d427418eff", "stitch_2102654533b25a0c", "stitch_241768555cc2b28b",
        "stitch_42e0e59b6bb78df9", "stitch_894a4015bb3641e2", "stitch_a6c0d19528540821",
        "stitch_d2f5eb97b18f7a31", "stitch_ea47f9d5b6f8bd86",
    ],
    "mistral-large-123b.tp8.prefill-2k": [
        "stitch_13fe6744dfd509da", "stitch_1ca2b4f6a47d9619", "stitch_34f4f93ced561d94",
        "stitch_4153302b9a950c61", "stitch_49140b8e35785d6b", "stitch_4aacf7ff5a6d7a87",
        "stitch_4e8060a5c468a1c7", "stitch_50ba1d43ba061d68", "stitch_973c3a1654db2ae6",
        "stitch_a2c69fd15acb4a14", "stitch_d729300e824ab4e4",
    ],
    "granite-moe-3b-a800m.attn-bf16.prefill-4k": [
        "stitch_1ae7df25bc715559", "stitch_42695837065d508c", "stitch_44d76f7fa7aac0af",
        "stitch_8dff3853295e4e09", "stitch_932155df81038699", "stitch_c5e0bbfebd47b9f3",
    ],
    "granite-4.0-h-micro.prefill-8k": [
        "stitch_06d4eb61e0f81380", "stitch_172eaed8df3e2f7c", "stitch_1bde63ac64bb1e8d",
        "stitch_24c864095d839b6b", "stitch_24c864095d839b6b", "stitch_2c9dbf526f705cfb",
        "stitch_325a099438b6a601", "stitch_37921a0cf672cbae", "stitch_404113360aa2d8d0",
        "stitch_40fc87311e647e5a", "stitch_48d054ceb6fea1ee", "stitch_4ecfda0e7e08b598",
        "stitch_5340e2ff5e11ac63", "stitch_5340e2ff5e11ac63", "stitch_6bb91ac94d93da80",
        "stitch_70aa51d22f3f9891", "stitch_866b0d402f234a97", "stitch_8e02cdf1d08719f3",
        "stitch_8e02cdf1d08719f3", "stitch_903d4ddf2cfe15ae", "stitch_92b18c01767cd6d4",
        "stitch_9731aa77116c9ebc", "stitch_9c068aecb946cf22", "stitch_9d2f8414c2f7a37f",
        "stitch_9e97bfd0a5969a3f", "stitch_a02a1e6f1dce8352", "stitch_a02a1e6f1dce8352",
        "stitch_adce27b3d62ae2a0", "stitch_ae0c0678ec61b067", "stitch_af45c40eb6ce4a70",
        "stitch_bb57e541d676baef", "stitch_bbfe014513e4193d", "stitch_d3b46c8ea020a5ff",
        "stitch_e2d6a5617f552ecc", "stitch_e8d8980e3aa20641", "stitch_ee5e1eb212846119",
        "stitch_f271482225ca93c1",
    ],
}


@pytest.mark.parametrize("workload", list(CELLS))
def test_the_benchmarks_cells_keep_their_kernels(workload):
    from stitchbench import harness

    cell = harness.load_cell(workload)
    s = cell.shape
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[s["dtype"]]

    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    fn = cell.program.build(cell.config, cell.batch, cell.seq)
    kinds = (sorted(set(cell.program.held_types(cell.config)))
             if hasattr(cell.program, "held_types") else [None])
    names = []
    for kind in kinds:
        weights = (cell.program.weight_shapes(s) if kind is None
                   else cell.program.weight_shapes(s, kind))
        args = [meta(cell.batch * cell.seq, s["d"])]
        args += [meta(*shape) for shape in weights.values()]
        args += [meta(cell.seq, s["head_dim"])] * 2
        cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
        names += [k.fn.name for k in cm.kernels]
    assert sorted(names) == CELLS[workload]


# ---------------------------------------------------------------------------
# the hand-written kernels' entry points
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


LAUNCHER_LIMITS = {
    # entry point, its arguments, the size named in the error
    "softmax rows": (stitched_softmax, lambda: (_meta(1 << 31, 1),), "rows is 2147483648"),
    "softmax columns": (stitched_softmax, lambda: (_meta(1, 1 << 31),), "cols is 2147483648"),
    "softmax cluster grid": (stitched_softmax, lambda: (_meta(1 << 28, 4096),),
                             "the cluster grid"),
    "rmsnorm rows": (ops.rmsnorm, lambda: (_meta(1 << 31, 1), _meta(1)), "rows is 2147483648"),
    "moe gate tokens": (ops.moe_gate, lambda: (_meta(1 << 31, 8), 2), "tokens is 2147483648"),
    "flash heads": (ops.attention, lambda: (_meta(1, 65536, 64, 64),) * 3, "query heads is 65536"),
    "flash batch": (ops.attention, lambda: (_meta(65536, 1, 64, 64),) * 3, "batch is 65536"),
    "flash positions": (ops.attention, lambda: (_meta(1, 1, 1 << 31, 64),) * 3,
                        "positions is 2147483648"),
    "decode batch": (ops.attention_decode,
                     lambda: (_meta(65536, 1, 64), _meta(65536, 1, 64, 64), _meta(65536, 1, 64, 64),
                              _meta(65536, dtype=torch.int32)), "batch is 65536"),
    "decode positions": (ops.attention_decode,
                         lambda: (_meta(1, 1, 64), _meta(1, 1, 1 << 31, 64), _meta(1, 1, 1 << 31, 64),
                                  _meta(1, dtype=torch.int32)), "cache positions is 2147483648"),
}


@pytest.mark.parametrize("case", list(LAUNCHER_LIMITS))
def test_hand_written_entry_point_refuses_what_its_launcher_cannot_index(case):
    fn, args, what = LAUNCHER_LIMITS[case]
    with pytest.raises(ValueError, match=what):
        fn(*args())


def test_a_launcher_int_past_a_c_int_raises():
    k = HandKernel("probe", ROWWISE, "none")
    with pytest.raises(ValueError, match="past a C int"):
        k.launch("sx_softmax_f32", 1 << 31, device=torch.device("cuda"))
    assert k.launches == 0
