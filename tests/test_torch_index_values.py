"""Values computed from indices alone are not held to the replicate limit on
the GPU.

A member of a fusion that cannot follow the launch grid is replicated, and
a replicated value is held to ``replicate_limit``: on the TPU every grid
step stages it whole.  A generated CUDA kernel stages none of the values
computed from indices alone (an ``iota`` or a ``constant``, and the
reshapes, broadcasts, transposes, elementwise ops and selects of them): it
computes each element it reads from that element's index.  So under a GPU
spec ``schedule.resolve_schedules`` lets such a member past the limit
(``schedule.index_values``), the memory plan gives it no slot, and the
tracer counts it (``schedule.index_values``, once a compile).  A causal
softmax whose mask is ``torch.where`` over ``torch.arange`` then plans as
one kernel: scale, mask, max, exp and sum.  ``TPU_V5E`` plans stay the
reference's (``tests/test_torch_plan_parity.py``).

Plans and text on meta tensors, and one plan run through its plain
versions on the CPU.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import stitch, tracing
from repro_torch.core import StitchOptions, trace
from repro_torch.core.latency import H100, TPU_V5E
from repro_torch.core.memory import plan_memory
from repro_torch.core.schedule import ROW, Sched, Unsatisfiable, index_values, resolve_schedules

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GRANITE = json.loads((ROOT / "stitchbench/configs/granite-moe-3b-a800m.attn.json").read_text())
HYBRID = json.loads((ROOT / "stitchbench/configs/granite-4.0-h-micro.json").read_text())
#: granite's layer at 4 x 4096 under ``H100``: the stitched RoPE and q kT,
#: and the division by the sum with p @ v, which keep their kernels
QK, PV = "stitch_42e0e59b6bb78df9", "stitch_241768555cc2b28b"
#: the same layer's kernels under ``TPU_V5E``, the parent's
TPU_KERNELS = [
    "stitch_11e09e3c804174ef", "stitch_12ffac9b2ee982d5", "stitch_1d08515984cc5773",
    "stitch_2f337184f8c17307", "stitch_3535ac0d10acbc9e", "stitch_428477397dd60f3d",
    "stitch_5925b09171581e8b", "stitch_5943832d0b2956b4", "stitch_6713e36254c618a1",
    "stitch_75995f6c953d67c6", "stitch_86b4375091d6295e", "stitch_c907ed48fd783957",
    "stitch_ef2834277a63dd95", "stitch_f51cc084b05c8a7a", "stitch_f7d772c185dab218",
    "stitch_f913f0a03e3953d0", "stitch_fcf3352227127d7f",
]
#: granite-4.0-h-micro's Mamba-2 plan at 1 x 8192 under ``H100``, the parent's:
#: its segment-sum masks (``torch.tril``) leave it as it was
MAMBA_KERNELS = [
    "stitch_06d4eb61e0f81380", "stitch_172eaed8df3e2f7c", "stitch_1bde63ac64bb1e8d",
    "stitch_24c864095d839b6b", "stitch_2c9dbf526f705cfb", "stitch_37921a0cf672cbae",
    "stitch_40fc87311e647e5a", "stitch_48d054ceb6fea1ee", "stitch_4ecfda0e7e08b598",
    "stitch_5340e2ff5e11ac63", "stitch_6bb91ac94d93da80", "stitch_70aa51d22f3f9891",
    "stitch_866b0d402f234a97", "stitch_8e02cdf1d08719f3", "stitch_903d4ddf2cfe15ae",
    "stitch_92b18c01767cd6d4", "stitch_9731aa77116c9ebc", "stitch_9c068aecb946cf22",
    "stitch_a02a1e6f1dce8352", "stitch_adce27b3d62ae2a0", "stitch_ae0c0678ec61b067",
    "stitch_af45c40eb6ce4a70", "stitch_bb57e541d676baef", "stitch_bbfe014513e4193d",
    "stitch_e8d8980e3aa20641", "stitch_ee5e1eb212846119", "stitch_f271482225ca93c1",
]
TOL = 2e-5


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _compiled(fn, args, spec):
    """The plan of ``fn`` under ``spec`` and the compile's count of values
    let past the replicate limit."""
    tracing.reset()
    cm = stitch(fn, options=StitchOptions(device_spec=spec), device="cpu").lower(*args).compile()
    return cm, tracing.snapshot().counters["schedule.index_values"]


def _granite(spec, batch=4, seq=4096):
    from stitchbench.programs import decoder_layer as dl

    s = dl.shape(GRANITE)
    args = [_meta(batch * seq, s["d"])] + [_meta(*sh) for sh in dl.weight_shapes(s).values()]
    return _compiled(dl.build(GRANITE, batch, seq), args + [_meta(seq, s["head_dim"])] * 2, spec)


def _ops(kernel):
    """Each member's op: its opcode, or its function for an elementwise op
    and the kind of a reduce."""
    return {m.attrs.get("fn", m.attrs.get("kind", m.opcode)) for m in kernel.fusion.members}


def _chain(kernels):
    """The one kernel holding the softmax's max."""
    (k,) = [k for k in kernels if any(m.opcode == "reduce" and m.attrs["kind"] == "max"
                                      for m in k.fusion.members)]
    return k


CHAIN_OPS = {"iota", "ge", "select", "mul", "max", "sub", "exp", "sum"}


def test_granite_softmax_is_one_kernel_on_the_gpu():
    cm, counted = _granite(H100)
    names = {k.fn.name for k in cm.kernels}
    chain = _chain(cm.kernels)
    assert CHAIN_OPS <= _ops(chain)
    blocks = int(re.search(r"(\d+) plan blocks", chain.fn.source).group(1))
    assert blocks >= H100.sm_count
    for k in cm.kernels:
        for r in k.fusion.roots:
            assert not (tuple(r.shape) == (4, 24, 4096, 4096) and r.dtype == np.bool_), k.fn.name
    assert {QK, PV} <= names and chain.fn.name not in (QK, PV)
    assert counted > 0


def test_tpu_plan_is_the_parents():
    cm, counted = _granite(TPU_V5E)
    assert sorted(k.fn.name for k in cm.kernels) == TPU_KERNELS
    assert counted == 0


def test_small_attention_on_the_gpu_plan_matches_eager():
    """Batch 1, 4 query heads, 2 KV heads, 1024 tokens, head_dim 16: the
    positions broadcast to (1024, 1024) int64 (8 MB) pass the limit, and q kT
    and the softmax become one kernel of a single schedule."""
    from stitchbench.programs import decoder_layer as dl

    cfg = dict(GRANITE, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               hidden_size=128, num_hidden_layers=1)
    batch, seq = 1, 1024
    fn = dl.build(cfg, batch, seq)
    layers, (cos, sin), (x,) = dl.make_inputs(cfg, batch, seq, 2**31 + 32, 1, torch.device("cpu"))
    args = (x, *layers[0].values(), cos, sin)
    tracing.reset()
    sf = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu")
    got = sf(*args)
    assert tracing.snapshot().counters["schedule.index_values"] > 0
    chain = _chain(sf._last.compiled.kernels)
    assert CHAIN_OPS <= _ops(chain) and chain.fn.source.startswith("// emit_fusion")
    torch.testing.assert_close(got, fn(*args), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the rule itself, on a masked row max
# ---------------------------------------------------------------------------

R, S = 4, 512        # (S, S) int64 positions: 2 MB, past the 512 KB limit


def _masked_max(positions):
    """max over the last dim of ``x`` where ``row >= column``, the positions
    from ``positions(b)``: (rows, columns), each (S, S) int64."""
    def fn(b, x, p):
        rows, cols = positions(b, p)
        keep = b.broadcast(rows >= cols, (R, S, S), dims=(1, 2))
        b.reduce(b.select(keep, x, b.lift(float("-inf"), x)), (2,), "max")
    return fn


def _from_iota(b, p):
    return b.iota((S, S), dim=0, dtype=np.int64), b.iota((S, S), dim=1, dtype=np.int64)


def _from_parameter(b, p):
    return (b.broadcast(p, (S, S), dims=(0,)), b.broadcast(p, (S, S), dims=(1,)))


def _resolve(positions, spec):
    mod = trace(_masked_max(positions), ("x", (R, S, S), np.float32), ("p", (S,), np.int64))
    members = [i for i in mod.instructions if i.opcode != "parameter"]
    root = members[-1]
    # four blocks a row: the (S, S) values cannot follow the grid, so each
    # is replicated
    return members, root, resolve_schedules(members, [root], {root.id: Sched("chunked", 1, 4, ROW)},
                                            spec=spec)


def test_index_values_pass_the_limit_on_the_gpu_and_take_no_slot():
    members, root, sol = _resolve(_from_iota, H100)
    computed = index_values(members)
    assert ({m.opcode for m in members if m.id in computed}
            == {"iota", "elementwise", "broadcast", "constant"})
    past = [m for m in members if m.id in sol.index_values]
    assert {m.opcode for m in past} == {"iota"} and all(m.bytesize > 512 * 1024 for m in past)
    assert all(sol.sched(m).kind == "replicated" for m in past)
    plan = plan_memory(members, [root], sol, 232320, H100)
    assert all(plan.action(m) == "INLINE" for m in past)


@pytest.mark.parametrize("positions, spec", [(_from_iota, TPU_V5E), (_from_iota, None),
                                             (_from_parameter, H100)])
def test_a_value_read_from_memory_or_a_tpu_plan_keeps_the_limit(positions, spec):
    with pytest.raises(Unsatisfiable, match="replicated .*B > limit"):
        _resolve(positions, spec)


# ---------------------------------------------------------------------------
# the hybrid: its Mamba-2 plan is the parent's, its attention one chain
# ---------------------------------------------------------------------------

def test_hybrid_mamba_plan_keeps_its_kernels_and_attention_has_one_chain():
    from stitchbench.programs import hybrid_layer as hl

    batch, seq = 1, 8192
    s = hl.shape(HYBRID)
    fn = hl.build(HYBRID, batch, seq)
    plans = {}
    for kind in ("mamba", "attention"):
        args = [_meta(batch * seq, s["d"])]
        args += [_meta(*sh) for sh in hl.weight_shapes(s, kind).values()]
        plans[kind] = _compiled(fn, args + [_meta(seq, s["head_dim"])] * 2, H100)
    (mamba, mamba_counted), (attention, counted) = plans["mamba"], plans["attention"]
    assert sorted(k.fn.name for k in mamba.kernels) == MAMBA_KERNELS
    assert mamba_counted == 0
    assert CHAIN_OPS <= _ops(_chain(attention.kernels)) and counted > 0
    assert len(attention.kernels) == 10
