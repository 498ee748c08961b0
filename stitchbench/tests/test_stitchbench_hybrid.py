"""The hybrid program (``programs/hybrid_layer.py``), its plain reference
(``reference/hybrid_layer.py``) and the ``mamba_fused_roofline`` reader,
at small widths on the CPU; the first timed request of a full-size run on
the card."""
import json
import math
import statistics
import time

import pytest
import torch

from stitchbench import harness, work
from stitchbench_cells import BENCH

WORKLOAD = "granite-4.0-h-micro.prefill-8k"
#: the configuration at small widths: the published ratios of heads, the
#: inner width twice the model's, one group of B and C, one period of a
#: Mamba-2 layer and an attention layer
SMALL = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=1, head_dim=8,
             intermediate_size=48, mamba_n_heads=4, mamba_d_head=16, mamba_d_state=8,
             mamba_chunk_size=4, layer_types=["mamba", "mamba", "attention"],
             layers_held=[0, 3], num_hidden_layers=3)
#: ``out_err`` of the stitched stack: the chunked SSD against the
#: sequential recurrence in float32, a few ulps over the stack's change
CPU_TOL = 2e-5


def _small(batch=2, seq=12):
    cell = harness.load_cell(WORKLOAD, BENCH)
    cell.config = dict(cell.config, **SMALL)
    cell.traffic = dict(cell.traffic, batch=batch, seq=seq)
    return cell


def test_the_cells_configuration_is_the_catalogs_with_its_cut():
    cell = harness.load_cell(WORKLOAD, BENCH)
    cfg, s = cell.config, cell.shape
    assert cfg["num_hidden_layers"] == 20 and len(cfg["layer_types"]) == 40
    types = cell.program.held_types(cfg)
    assert (types.count("mamba"), types.count("attention")) == (18, 2)
    assert types[0] == "mamba" and types[-1] == "attention"
    assert (s["d"], s["mamba_heads"], s["mamba_head_dim"], s["d_state"], s["ff"]) == \
        (2048, 64, 64, 128, 8192)
    assert (s["heads"], s["kv_heads"], s["head_dim"], s["inner"]) == (32, 8, 64, 4096)


def test_stitched_stack_matches_the_sequential_reference():
    cell = _small()
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 2**31 + 5, 2,
                                      torch.device("cpu"))
    sf = harness.compile_layer(cell, torch.device("cpu"))
    for i, x in enumerate(inputs[2]):
        assert harness.errors(cell, inputs, x, harness.request(sf, inputs, i))["out_err"] < CPU_TOL
    assert sf.num_fallbacks == 0 and sf.num_compiles == 2


def test_the_reference_recurrence_is_the_ssds_matrix():
    """``y_t = sum_{s <= t} (c_t . b_s) exp(sum_{s < r <= t} dt_r a) dt_s x_s``."""
    from stitchbench.reference import hybrid_layer as ref

    gen = torch.Generator().manual_seed(3)
    seq, heads, hd, n = 11, 3, 4, 5
    x = torch.randn(seq, heads, hd, generator=gen, dtype=torch.float64)
    dt = torch.rand(seq, heads, generator=gen, dtype=torch.float64) * 0.5
    a = -torch.rand(heads, generator=gen, dtype=torch.float64) * 4
    b, c = (torch.randn(seq, n, generator=gen, dtype=torch.float64) for _ in range(2))
    la = torch.cumsum(dt * a, dim=0)
    decay = torch.exp(la[:, None, :] - la[None, :, :])               # (t, s, heads)
    causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool))[:, :, None]
    m = torch.where(causal, (c @ b.T)[:, :, None] * decay, 0.0)
    want = torch.einsum("tsh,shp->thp", m, x * dt[:, :, None])
    torch.testing.assert_close(ref.recurrence(x, dt, a, b, c), want, rtol=1e-12, atol=1e-12)


def test_reference_is_causal_and_per_sequence():
    cell = _small(batch=2, seq=8)
    layers, (cos, sin), (x,) = cell.program.make_inputs(cell.config, 2, 8, 7, 1,
                                                        torch.device("cpu"))

    def fwd(x):
        return cell.reference.forward(cell.config, cell.shape, 8, layers, x, cos, sin)

    base = fwd(x)
    moved = x.clone()
    moved[5] += 1.0
    after = fwd(moved)
    assert torch.equal(base[:5], after[:5]) and torch.equal(base[8:], after[8:])
    assert not torch.equal(base[5:8], after[5:8])


def test_inputs_repeat_with_the_seed_and_take_a_large_one():
    cell = _small()
    seed = 2**31 + 2**30 + 17
    a1, t1, x1 = cell.program.make_inputs(cell.config, 1, 8, seed, 2, torch.device("cpu"))
    a2, _, x2 = cell.program.make_inputs(cell.config, 1, 8, seed, 2, torch.device("cpu"))
    a3, _, _ = cell.program.make_inputs(cell.config, 1, 8, seed + 1, 2, torch.device("cpu"))
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a1, a2) for k in p)
    assert all(torch.equal(p, q) for p, q in zip(x1, x2))
    assert not torch.equal(a1[0]["w_in"], a3[0]["w_in"])
    assert list(a1[0]) == list(cell.program.MAMBA_WEIGHTS)
    assert list(a1[2]) == list(cell.program.ATTENTION_WEIGHTS)
    # NoPE: cos 1, sin 0; dt_bias the inverse softplus of dt in [1e-3, 0.1]
    assert torch.equal(t1[0], torch.ones_like(t1[0])) and not t1[1].any()
    dt = torch.nn.functional.softplus(a1[0]["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(a1[0]["D"], torch.ones_like(a1[0]["D"]))
    assert 0.0 <= float(a1[0]["A_log"].min()) and float(a1[0]["A_log"].max()) <= math.log(16)


def test_work_counts_the_ssd_as_the_chunked_outputs_need_it():
    cell = harness.load_cell(WORKLOAD, BENCH)
    c = cell.program.mamba_counts(cell.config, 1, 8192)
    assert c["fused_flops"] < c["fused_flops_dense"]
    # the products within a chunk at 1 x 8192: C Bᵀ and its product with x
    # over the causal half of each 256 x 256 chunk, 32 chunks
    within = 2 * 32 * (256 * 257 / 2) * (128 + 64 * 64)
    assert within < c["fused_flops"] < 3 * within
    w = cell.program.WORK(cell.config, 1, 8192)
    attn = work.decoder_stack(dict(cell.program.attention_config(cell.config),
                                   num_hidden_layers=2), 1, 8192)
    assert w.tokens == 8192
    assert w.gemm_flops == pytest.approx(attn.gemm_flops + 18 * c["gemm_flops"])
    assert w.fused_bytes == pytest.approx(attn.fused_bytes + 18 * c["fused_bytes"])


# ---------------------------------------------------------------------------
# the metric's reader
# ---------------------------------------------------------------------------

def _run_with(events, spans_attrs):
    from repro_torch import tracing

    tracing.reset()
    for attrs in spans_attrs:
        with tracing.span("compile", **attrs):
            pass
    cell = harness.load_cell(WORKLOAD, BENCH)
    run = harness.Run(cell=cell, work=None, calls=2, layers=20)
    run.events = events
    return run


def test_the_reader_counts_the_mamba_plans_kernels_by_their_launches():
    from stitchbench.metrics import mamba_fused_roofline as metric

    mamba = {"arguments": 16, "kernels": ["stitch_aaaaaaaaaaaaaaaa_cumsum",
                                          "stitch_bbbbbbbbbbbbbbbb_mul_mean"]}
    attention = {"arguments": 12, "kernels": ["stitch_bbbbbbbbbbbbbbbb_mul_mean",
                                              "stitch_cccccccccccccccc_div"]}
    events = [(0.0, "stitch_aaaaaaaaaaaaaaaa_cumsum(float const*)", 100.0),
              (1.0, "stitch_bbbbbbbbbbbbbbbb_mul_mean(float const*)", 200.0),
              (2.0, "stitch_cccccccccccccccc_div(float const*)", 999.0),
              (3.0, "sm80_xmma_gemm_f32f32", 999.0)]
    run = _run_with(events, [mamba, attention])
    cell = run.cell
    need = 18 * cell.program.mamba_seconds_at_roofline(cell.config, cell.batch, cell.seq)
    # the shared kernel's time counts in the Mamba-2 layers' share of its launches
    us = 100.0 + 200.0 * 18 / 20
    assert metric.read(run) == pytest.approx(100.0 * need * 2 / (us / 1e6))


def test_the_reader_finds_nothing_without_the_kernels_attribute():
    from stitchbench.metrics import mamba_fused_roofline as metric

    run = _run_with([(0.0, "stitch_aaaaaaaaaaaaaaaa_cumsum", 1.0)],
                    [{"function": "hybrid_layer"}])
    assert metric.read(run) is None
    run.events = []
    assert metric.read(run) is None


def test_the_metric_is_read_in_the_new_cell_only():
    spec = next(m for m in BENCH["per_layer"] if m["name"] == "mamba_fused_roofline")
    assert spec["workloads"] == [WORKLOAD] and spec["moves"] == "tokens_per_s"
    assert "mamba_fused_roofline" in [m["name"] for m in harness.load_cell(WORKLOAD,
                                                                           BENCH).per_layer]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_the_first_timed_request_is_no_outlier(card):
    """Both plans are built and captured before the window (the stack
    begins with a Mamba-2 layer and ends with an attention layer), so the
    first timed request takes as long as the others."""
    cell = harness.load_cell(WORKLOAD)
    result, info = harness.run_cell(cell, 4_100_000_007, 6.0, False, card, time.perf_counter())
    each = info["request_ms"]["each"]
    assert result["correct"], json.dumps(result["checks"])
    assert each[0] <= 1.5 * statistics.median(each), each
