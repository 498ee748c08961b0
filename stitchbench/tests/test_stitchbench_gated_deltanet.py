"""The Gated DeltaNet program (``programs/gated_deltanet_layer.py``), its
plain reference (``reference/gated_deltanet_layer.py``), its counts of work
and the ``deltanet_fused_roofline`` and ``deltanet_kernels_per_call``
readers, at small widths on the CPU; the faults of
``test_stitchbench_faults.py`` in this cell."""
import json
import time

import pytest
import torch

from stitchbench import harness, work
from stitchbench_cells import BENCH
from test_stitchbench_faults import Faulty, altered, half_batch, unchanged

WORKLOAD = "olmo-hybrid-7b.prefill-8k"
METRICS = ("deltanet_fused_roofline", "deltanet_kernels_per_call")
#: the configuration at small widths: full attention 4 heads x 8, the
#: linear layers 2 heads with keys of 8 and values of 16, chunks of 4, two
#: Gated DeltaNet layers and a full-attention layer
SMALL = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=4, head_dim=8,
             intermediate_size=48, linear_num_key_heads=2, linear_num_value_heads=2,
             linear_key_head_dim=8, linear_value_head_dim=16, chunk_size=4,
             layer_types=["linear_attention", "linear_attention", "full_attention"],
             layers_held=[0, 3], num_hidden_layers=3)
#: ``out_err`` of the stitched stack: the chunked delta rule against the
#: recurrence one position at a time, in float32, a few ulps of the output
#: over the stack's change to ``x``
CPU_TOL = 2e-5


def _small(batch=2, seq=8):
    cell = harness.load_cell(WORKLOAD, BENCH)
    cell.config = dict(cell.config, **SMALL)
    cell.traffic = dict(cell.traffic, batch=batch, seq=seq)
    return cell


@pytest.fixture(scope="module")
def stitched():
    """The small cell's layer through ``stitch``, compiled once for the
    module's runs (both plans built by its first request)."""
    cell = _small()
    sf = harness.compile_layer(cell, torch.device("cpu"))
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 3, 1,
                                      torch.device("cpu"))
    harness.request(sf, inputs, 0)
    return sf


def test_the_cells_configuration_is_the_catalogs_with_its_cut():
    cell = harness.load_cell(WORKLOAD, BENCH)
    cfg, s = cell.config, cell.shape
    assert cfg["num_hidden_layers"] == 8 and len(cfg["layer_types"]) == 32
    assert cfg["layer_types"] == (["linear_attention"] * 3 + ["full_attention"]) * 8
    types = cell.program.held_types(cfg)
    assert (types.count("linear_attention"), types.count("full_attention")) == (6, 2)
    assert types[0] == "linear_attention" and types[-1] == "full_attention"
    assert (s["d"], s["ff"], s["heads"], s["kv_heads"], s["head_dim"]) == (3840, 11008, 30, 30, 128)
    assert (s["lin_heads"], s["dk"], s["dv"], s["d_conv"], s["chunk"]) == (30, 96, 192, 4, 64)
    assert cfg["linear_allow_neg_eigval"] and cfg["rope_parameters"]["rope_theta"] is None
    assert cfg["rms_norm_eps"] == 1e-6 and cfg["vocab_size"] == 100352
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == list(cfg["reduced"]) == ["num_hidden_layers"]
    assert entry["source"] == cfg["source"]


def test_stitched_stack_matches_the_recurrent_reference(stitched):
    cell = _small()
    inputs = cell.program.make_inputs(cell.config, cell.batch, cell.seq, 2**31 + 5, 2,
                                      torch.device("cpu"))
    for i, x in enumerate(inputs[2]):
        y = harness.request(stitched, inputs, i)
        assert harness.errors(cell, inputs, x, y)["out_err"] < CPU_TOL
    assert stitched.num_fallbacks == 0 and stitched.num_compiles == 2


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
    assert not torch.equal(a1[0]["wq"], a3[0]["wq"])
    assert list(a1[0]) == list(cell.program.LINEAR_WEIGHTS)
    assert list(a1[2]) == list(cell.program.FULL_WEIGHTS)
    assert torch.equal(t1[0], torch.ones_like(t1[0])) and not t1[1].any()
    for name in ("conv_q", "conv_k", "conv_v"):
        assert float(a1[0][name].abs().max()) <= 0.5
    assert float(a1[0]["g_norm"].mean()) == pytest.approx(1.0, abs=0.05)


def test_work_counts_the_delta_rule_as_the_chunked_outputs_need_it():
    """At 1 x 8 tokens, chunks of 4, 2 heads of keys 8 and values 16: a
    head's products counted by hand."""
    cell = _small()
    c = cell.program.deltanet_counts(cell.config, 1, 8)
    # a chunk: k_beta kᵀ 6 strict pairs, u 10 lower pairs and w 10, q kᵀ
    # 10 and attn v_new 10; the substitution's rows 1, 2 and 3 read 0, 1
    # and 3 (j < k < i) pairs; two chunks; one carried chunk of three products
    within = 2 * 8 * 6 + 2 * (0 + 1 + 3) + 2 * 10 * (16 + 8) + 2 * 10 * 8 + 2 * 10 * 16
    carried = 3 * 2 * 4 * 8 * 16
    assert c["fused_flops"] == pytest.approx(2 * (2 * within + carried))
    dense = 2 * 8 * 16 + 2 * (1 + 4 + 9) + 2 * 16 * 24 + 2 * 16 * 8 + 2 * 16 * 16
    assert c["fused_flops_dense"] == pytest.approx(2 * (2 * dense + 2 * 3 * 2 * 4 * 8 * 16))
    gemms = [(8, 32, 16), (8, 32, 16), (8, 32, 32), (8, 32, 2), (8, 32, 2), (8, 32, 32),
             (8, 32, 32), (8, 32, 48), (8, 32, 48), (8, 48, 32)]
    assert c["gemm_flops"] == pytest.approx(sum(work.gemm_flops(*g) for g in gemms))
    elems = (8 * 32 + 8 * (16 + 16 + 32 + 2 + 2 + 32) + 4 * 64 + 2 + 2 + 16
             + 8 * 32 + 8 * 32 + 32 + 2 * 8 * 32 + 3 * 8 * 48 + 8 * 32 + 32 + 8 * 32)
    assert c["fused_bytes"] == 4 * elems
    w = cell.program.WORK(cell.config, 1, 8)
    full = work.decoder_stack(dict(cell.program.full_config(cell.config), num_hidden_layers=1),
                              1, 8)
    assert w.tokens == 8 and w.peak_flops == work.PEAK_FLOPS["float32"]
    assert w.gemm_flops == pytest.approx(full.gemm_flops + 2 * c["gemm_flops"])
    assert w.fused_flops == pytest.approx(full.fused_flops + 2 * c["fused_flops"])
    assert w.fused_bytes == pytest.approx(full.fused_bytes + 2 * c["fused_bytes"])
    assert cell.program.deltanet_seconds_at_roofline(cell.config, 1, 8) == pytest.approx(
        max(c["fused_flops"] / 67e12, c["fused_bytes"] / work.HBM_BYTES_PER_S))


def test_both_plans_of_the_cell_replay_their_cuda_graph():
    """At 1 x 8192 each plan's replayed call dispatches fewer than its
    eager one, so on the card both replay as one CUDA graph (``replay_mode``
    is ``eager`` on the CPU whatever the counts)."""
    from repro_torch import stitch
    from repro_torch.core import StitchOptions
    from repro_torch.core.latency import H100

    cell = harness.load_cell(WORKLOAD, BENCH)
    s = cell.shape
    fn = cell.program.build(cell.config, cell.batch, cell.seq)
    for kind in ("linear_attention", "full_attention"):
        args = [torch.empty(cell.seq, s["d"], device="meta")]
        args += [torch.empty(v, device="meta") for v in cell.program.weight_shapes(s, kind).values()]
        args += [torch.empty(cell.seq, s["head_dim"], device="meta")] * 2
        cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
        assert cm.stats.traced_dispatches_per_call < cm.stats.eager_dispatches_per_call, kind
        assert (cm.stats.loop_calls > 0) == (kind == "linear_attention")


# ---------------------------------------------------------------------------
# the metrics' readers
# ---------------------------------------------------------------------------

def _run_with(events, spans_attrs, calls=2):
    from repro_torch import tracing

    tracing.reset()
    for attrs in spans_attrs:
        with tracing.span("compile", **attrs):
            pass
    cell = harness.load_cell(WORKLOAD, BENCH)
    run = harness.Run(cell=cell, work=None, calls=calls, layers=8)
    run.events = events
    return run


def _metric(name):
    return harness._module(harness.HERE, "metrics", name)


LINEAR = {"arguments": 21, "kernels": ["stitch_aaaaaaaaaaaaaaaa_cumsum",
                                       "stitch_bbbbbbbbbbbbbbbb_mul_mean",
                                       "stitch_dddddddddddddddd_dot"]}
FULL = {"arguments": 14, "kernels": ["stitch_bbbbbbbbbbbbbbbb_mul_mean",
                                     "stitch_cccccccccccccccc_div"]}
#: a request: each linear kernel once a layer, the loop body's kernel
#: twice a layer, the shared kernel in all 8 layers, and library products
EVENTS = ([(0.0, "stitch_aaaaaaaaaaaaaaaa_cumsum(float const*)", 10.0)] * 6
          + [(1.0, "stitch_dddddddddddddddd_dot(float const*)", 5.0)] * 12
          + [(2.0, "stitch_bbbbbbbbbbbbbbbb_mul_mean(float const*)", 20.0)] * 8
          + [(3.0, "stitch_cccccccccccccccc_div(float const*)", 999.0)] * 2
          + [(4.0, "sm80_xmma_gemm_f32f32", 999.0)] * 40)


def test_the_readers_attribute_the_linear_plans_kernels_by_their_launches():
    run = _run_with(EVENTS * 2, [LINEAR, FULL])
    cell = run.cell
    assert len(cell.program.LINEAR_WEIGHTS) + 3 == LINEAR["arguments"]
    need = 6 * cell.program.deltanet_seconds_at_roofline(cell.config, 1, 8192)
    # the shared kernel counts in the linear layers' 6 of its 8 launches
    us = 2 * (6 * 10.0 + 12 * 5.0 + 8 * 20.0 * 6 / 8)
    assert _metric("deltanet_fused_roofline").read(run) == pytest.approx(
        100.0 * need * 2 / (us / 1e6))
    # a linear layer call: its kernel, the body's twice, the shared one
    assert _metric("deltanet_kernels_per_call").read(run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_finds_nothing_without_spans_or_the_kernels_attribute(name):
    from repro_torch import tracing

    tracing.reset()
    run = _run_with(EVENTS, [])
    assert _metric(name).read(run) is None
    run = _run_with(EVENTS, [{"function": "gated_deltanet_layer", "arguments": 21}])
    assert _metric(name).read(run) is None
    run = _run_with([], [LINEAR, FULL])
    assert _metric(name).read(run) is None


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_finds_nothing_without_a_tracer(name, monkeypatch):
    import sys

    import repro_torch

    run = _run_with(EVENTS, [LINEAR, FULL])
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _metric(name).read(run) is None


def test_the_metrics_are_read_in_the_new_cell_only():
    for name in METRICS:
        spec = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert spec["workloads"] == [WORKLOAD] and spec["moves"] == "tokens_per_s"
        for w in BENCH["workloads"]:
            read = [m["name"] for m in harness.load_cell(w["name"], BENCH).per_layer]
            assert (name in read) == (w["name"] == WORKLOAD), (name, w["name"])


# ---------------------------------------------------------------------------
# faults in this cell
# ---------------------------------------------------------------------------

def _run(stitched, fault, traced=False):
    cell = _small()
    cell.limits = {"out_err": {"limit": CPU_TOL}}
    if fault is half_batch:
        fault = lambda x, y: half_batch(x, y, cell.batch)  # noqa: E731
    stitch = (lambda fn, **kw: stitched) if fault is None else (
        lambda fn, **kw: Faulty(stitched, fault))
    result, _ = harness.run_cell(cell, 2**32 + 5, 0.1, traced, torch.device("cpu"),
                                 time.perf_counter(), stitch=stitch)
    return result


def test_a_sound_run_is_correct(stitched):
    result = _run(stitched, None)
    assert result["correct"] and result["checks"]["out_err"]["value"] < CPU_TOL


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_a_fault_is_not_correct(stitched, fault):
    result = _run(stitched, fault)
    assert not result["correct"]
    assert result["checks"]["out_err"]["value"] > CPU_TOL


def test_a_traced_run_is_judged_alike(stitched):
    assert not _run(stitched, altered, traced=True)["correct"]


def test_the_limit_lies_between_its_readings():
    limits = json.loads((harness.HERE / "limits" / f"{WORKLOAD}.json").read_text())["limits"]
    lim = limits["out_err"]
    assert len(lim["lower"]) == len(lim["upper"]) == 14
    assert 3 * max(lim["lower"]) <= lim["limit"] <= min(lim["upper"]) / 3
