"""The port's measured-cost autotuning, mirroring ``tests/test_measure.py``:
the store's schema, eviction of corrupt and wrong-device rows, the device
fingerprints that keep a CPU timing from ever serving a card compile, the
timing harness, and the closed loop across two compiles (a warm store takes
no new measurement).  On the CPU every kernel is timed through its plain
version; on the card ``chip_smoke.py`` runs the same loop with CUDA events.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import StitchOptions, compile_module
from repro_torch.core.latency import TPU_V5E
from repro_torch.core.measure import (
    MEASURE_SCHEMA_VERSION,
    MeasuredCost,
    MeasuredCostStore,
    device_fingerprint,
    emit_group,
    measure_callable,
    measure_group,
    measure_kernel,
)
from repro_torch.core.pipeline import _options_fingerprint
from repro_torch.graphs import ALL_GRAPHS, reduce_towers_graph, stitch_pipeline_graph

CPU = device_fingerprint(TPU_V5E, "cpu")


def _cards(monkeypatch, *names):
    """Fingerprints of cards of the given names, without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fps = []
    for name in names:
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        fps.append(device_fingerprint(TPU_V5E, "cuda"))
    return fps


def _fusable(module):
    return [i for i in module.instructions
            if i.opcode not in ("parameter", "constant") and not i.is_library_call]


def _rewrite(path, fn):
    with open(path) as f:
        rows = json.load(f)
    for key in list(rows):
        rows[key] = fn(rows[key])
    with open(path, "w") as f:
        json.dump(rows, f)


# ------------------------------------------------------------ the store
def test_store_roundtrip(tmp_path):
    path = str(tmp_path / "measured.json")
    s = MeasuredCostStore(path, device_fp=CPU)
    assert s.get("sig") is None and s.misses == 1
    s.put("sig", 1.5e-3, model_s=2e-6, repeats=5)
    s.save()
    s2 = MeasuredCostStore(path, device_fp=CPU)
    assert s2.get("sig") == MeasuredCost(cost_s=1.5e-3, model_s=2e-6, repeats=5)
    assert s2.hits == 1 and s2.misses == 0 and len(s2) == 1
    with open(path) as f:
        (key, rec), = json.load(f).items()
    assert key == f"{CPU}|sig"
    assert rec == {"version": MEASURE_SCHEMA_VERSION, "device": CPU, "cost_s": 1.5e-3,
                   "model_s": 2e-6, "repeats": 5}


def test_a_store_needs_its_device():
    with pytest.raises(ValueError, match="device fingerprint"):
        MeasuredCostStore()


@pytest.mark.parametrize("payload", [
    {"version": MEASURE_SCHEMA_VERSION - 1, "device": CPU, "cost_s": 1e-3},   # stale schema
    {"version": MEASURE_SCHEMA_VERSION, "device": "0" * 16, "cost_s": 1e-3},  # another device
    {"version": MEASURE_SCHEMA_VERSION, "device": CPU, "cost_s": "garbage"},
    {"version": MEASURE_SCHEMA_VERSION, "device": CPU, "cost_s": 0.0},
    {"version": MEASURE_SCHEMA_VERSION, "device": CPU, "cost_s": float("nan")},
    {},
    "not even a dict",
])
def test_bad_rows_are_evicted_not_raised(tmp_path, payload):
    path = str(tmp_path / "measured.json")
    s = MeasuredCostStore(path, device_fp=CPU)
    s.put("sig", 1e-3)
    s.save()
    _rewrite(path, lambda rec: payload)
    s2 = MeasuredCostStore(path, device_fp=CPU)
    assert s2.get("sig") is None
    assert s2.stale_discards == 1 and s2.misses == 1 and len(s2) == 0


def test_fingerprints_keep_the_cpu_and_each_card_apart(monkeypatch):
    h100, other = _cards(monkeypatch, "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB")
    assert len({CPU, h100, other}) == 3
    assert device_fingerprint(TPU_V5E, "cpu") == CPU


def test_a_cpu_timing_never_serves_a_card_compile(tmp_path, monkeypatch):
    path = str(tmp_path / "measured.json")
    opts = StitchOptions(max_blocks=64, autotune=True, measure_repeats=1, tuning_store_path=path)
    compile_module(reduce_towers_graph(num_towers=1), opts, device="cpu")
    (h100,) = _cards(monkeypatch, "NVIDIA H100 80GB HBM3")
    card_store = MeasuredCostStore(path, device_fp=h100)
    assert len(card_store) > 0
    ro = StitchOptions(max_blocks=64)
    comp = compile_module(reduce_towers_graph(num_towers=1), ro, device="cpu",
                          measured_store=card_store)
    assert comp.stats.measured_hits == 0 and comp.stats.measured_misses > 0
    assert all(r.measured_cost_s is None for r in comp.stats.reports)


# ----------------------------------------------------------- the harness
def test_measure_callable_median_with_warmup():
    calls = []
    t = measure_callable(lambda x: calls.append(1), [np.ones(4)], "cpu", repeats=3, warmup=2)
    assert t >= 0.0 and len(calls) == 5


def test_emit_and_measure_single_schedule_group():
    members = _fusable(reduce_towers_graph(num_towers=1))
    kernel = emit_group(members, max_blocks=64, device="cpu")
    assert kernel is not None and not kernel.stitched
    assert measure_kernel(kernel, "cpu", repeats=2) > 0.0
    assert measure_group(members, repeats=1, max_blocks=64, device="cpu") > 0.0


def test_a_measurement_leaves_the_launch_counter_as_it_found_it(monkeypatch):
    """A timing's launches are not the plan's: whatever the timed calls
    tick, the counter reads afterwards what it read before."""
    from repro_torch.core import measure

    kernel = emit_group(_fusable(reduce_towers_graph(num_towers=1)), max_blocks=64, device="cpu")
    kernel.fn.launches = 7

    def ticking(fn, args, device, repeats, warmup):
        kernel.fn.launches += warmup + repeats * measure.GRAPH_BATCH
        return 1e-6

    monkeypatch.setattr(measure, "measure_callable", ticking)
    assert measure_kernel(kernel, "cpu", repeats=3) == 1e-6
    assert kernel.fn.launches == 7


def test_emit_and_measure_stitched_group():
    kernel = emit_group(_fusable(stitch_pipeline_graph()), max_blocks=64, device="cpu")
    assert kernel is not None and kernel.stitched
    assert measure_kernel(kernel, "cpu", repeats=1) > 0.0


def test_infeasible_groups_give_none():
    members = _fusable(stitch_pipeline_graph())
    assert emit_group(members, vmem_limit=1, device="cpu") is None
    assert measure_group(members, vmem_limit=1, device="cpu") is None


# ------------------------------------------------------- options and salts
def test_measure_repeats_validated():
    with pytest.raises(ValueError, match="measure_repeats"):
        StitchOptions(measure_repeats=0)


def test_autotune_knobs_salt_the_kernel_cache_fingerprint():
    base = _options_fingerprint(StitchOptions(max_blocks=64), "cpu")
    for kw in ({"autotune": True}, {"measure_repeats": 9}, {"tuning_store_path": "t.json"}):
        assert base != _options_fingerprint(StitchOptions(max_blocks=64, **kw), "cpu")
    assert base != _options_fingerprint(StitchOptions(max_blocks=64), "cuda")


def test_defaults_are_the_references():
    opts = StitchOptions()
    assert (opts.autotune, opts.measure_repeats, opts.tuning_store_path) == (False, 5, None)


# ----------------------------------------------------------- the closed loop
def test_autotune_measures_persists_and_a_warm_store_measures_nothing(tmp_path):
    """Under the greedy planner the plan does not depend on costs, so the
    warm compile finds every kernel of its plan in the store."""
    path = str(tmp_path / "measured.json")
    opts = StitchOptions(max_blocks=64, planner="greedy", autotune=True, measure_repeats=2,
                         tuning_store_path=path)
    c1 = compile_module(reduce_towers_graph(num_towers=2), opts, device="cpu")
    assert c1.stats.measurements_taken > 0 and c1.stats.measured_hits == 0
    assert c1.stats.model_error_pct is not None
    with open(path) as f:
        rows = json.load(f)
    assert rows and all(k.startswith(CPU + "|") and r["device"] == CPU for k, r in rows.items())

    c2 = compile_module(reduce_towers_graph(num_towers=2), opts, device="cpu")
    assert c2.stats.measurements_taken == 0 and c2.stats.measured_hits > 0
    assert _plan_shape(c2) == _plan_shape(c1)
    for r in c2.stats.reports:
        assert r.measured_cost_s is not None and r.cost_s == r.measured_cost_s


def test_measured_costs_change_the_cost_planners_plan(tmp_path):
    """The closed loop: the plain versions' host times (milliseconds)
    contradict the analytic model (microseconds) about packing two towers
    into one kernel, so the warm compile re-plans from what it measured,
    measures the kernels it newly commits, and still computes the module."""
    path = str(tmp_path / "measured.json")
    opts = StitchOptions(max_blocks=64, autotune=True, measure_repeats=2, tuning_store_path=path)
    cold = compile_module(reduce_towers_graph(num_towers=2), opts, device="cpu")
    warm = compile_module(reduce_towers_graph(num_towers=2), opts, device="cpu")
    assert cold.stats.stitched_kernels == 1 and cold.stats.measurements_taken == 1
    assert warm.stats.measured_hits > 0 and warm.stats.stitched_kernels > 1
    assert all(r.measured_cost_s is not None for r in warm.stats.reports)
    from repro_torch.core import reference_execute
    from repro_torch.graphs import random_feeds
    m = warm.executable.module
    feeds = random_feeds(m, np.random.RandomState(0))
    want = reference_execute(m, feeds, device="cpu")
    got = warm(feeds)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-5)


def test_read_only_store_reuses_measurements(tmp_path):
    path = str(tmp_path / "measured.json")
    compile_module(reduce_towers_graph(num_towers=2),
                   StitchOptions(max_blocks=64, autotune=True, measure_repeats=1,
                                 tuning_store_path=path), device="cpu")
    ro = compile_module(reduce_towers_graph(num_towers=2),
                        StitchOptions(max_blocks=64, tuning_store_path=path), device="cpu")
    assert ro.stats.measurements_taken == 0 and ro.stats.measured_hits > 0


def _plan_shape(comp):
    return sorted((r.num_ops, r.blocks, r.num_phases, r.signature[-64:]) for r in comp.stats.reports)


@pytest.mark.parametrize("planner", ["greedy", "cost"])
def test_an_empty_or_foreign_store_leaves_every_plan_as_analytic(planner, tmp_path, monkeypatch):
    (h100,) = _cards(monkeypatch, "NVIDIA H100 80GB HBM3")
    for name, build in ALL_GRAPHS.items():
        opts = StitchOptions(max_blocks=64, planner=planner)
        ref = _plan_shape(compile_module(build(), opts, device="cpu"))
        path = str(tmp_path / f"{name}.json")
        compile_module(build(), StitchOptions(max_blocks=64, planner=planner, autotune=True,
                                              measure_repeats=1, tuning_store_path=path),
                       device="cpu")
        for store in (MeasuredCostStore(device_fp=CPU), MeasuredCostStore(path, device_fp=h100)):
            comp = compile_module(build(), opts, device="cpu", measured_store=store)
            assert comp.stats.measured_hits == 0 and comp.stats.measurements_taken == 0, name
            assert _plan_shape(comp) == ref, name
