"""The readers of the port's tracer (``spans.py`` and the metrics that use
it): nothing read where the port has no tracer or it holds nothing, and on
a CPU run of a cell the spans' sums, with nothing built, captured into a
CUDA graph or replayed."""
import sys
import time

import pytest
import torch

from stitchbench import harness
from stitchbench_cells import WORKLOADS, small_cell

READERS = ["capture_s", "passes_s", "build_s", "graph_capture_s", "copy_bytes_per_call"]


def _read(name):
    return harness._module(harness.HERE, "metrics", name).read(None)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_a_tracer(name, monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_from_an_empty_tracer(name):
    from repro_torch import tracing

    tracing.reset()
    assert _read(name) is None


def test_a_cpu_run_reads_the_spans_sums():
    from repro_torch import tracing

    tracing.reset()
    cell = small_cell(WORKLOADS[0])
    result, info = harness.run_cell(cell, 2**31 + 7, 1.0, True, torch.device("cpu"),
                                    time.perf_counter())
    spans = tracing.snapshot().spans
    by_id = {s.id: s for s in spans}
    metrics = result["metrics"]
    assert metrics["capture_s"] == {"value": sum(s.seconds for s in spans
                                                 if s.name == "capture"), "unit": "s"}
    assert metrics["capture_s"]["value"] == info["setup"]["capture_s"]
    passes = [s for s in spans if s.name.startswith("pass.") or s.name == "verify"]
    outermost = [s for s in passes if not (s.parent in by_id and by_id[s.parent] in passes)]
    assert outermost and metrics["passes_s"]["value"] == pytest.approx(
        sum(s.seconds for s in outermost))
    assert metrics["passes_s"]["value"] <= info["setup"]["compile_module_s"]
    # the CPU builds nothing and replays eagerly
    assert not {"build_s", "graph_capture_s", "copy_bytes_per_call"} & set(metrics)
    assert result["correct"]


def test_readers_over_a_synthetic_trace(monkeypatch):
    """Nested compiles count once, a build inside a pass is ``build_s``'s
    and not ``passes_s``', the copy bytes are a replay's."""
    from repro_torch import tracing

    from stitchbench import spans

    t = tracing.Tracer()
    with t.span("compile"):
        with t.span("capture"):
            time.sleep(0.002)
        with t.span("compile_module"):
            with t.span("pass.submodule"):
                with t.span("compile_module"):
                    with t.span("pass.fusion"):
                        time.sleep(0.002)
            with t.span("pass.codegen"):
                with t.span("build"):
                    time.sleep(0.003)
            with t.span("verify"):
                pass
    with t.span("call"):
        with t.span("execute", mode="graph"):
            with t.span("graph_capture"):
                pass
    for _ in range(4):
        t.count("replay.calls", 1)
        t.count("replay.copy_bytes", 1000)
    monkeypatch.setattr(spans, "snapshot", t.snapshot)
    got = {s.name: s for s in t.snapshot().spans}
    outer = [s for s in t.snapshot().spans if s.name in ("pass.submodule", "pass.codegen",
                                                          "verify")]
    assert _read("passes_s") == pytest.approx(sum(s.seconds for s in outer)
                                              - got["build"].seconds)
    assert _read("build_s") == got["build"].seconds
    assert _read("capture_s") == got["capture"].seconds
    assert _read("graph_capture_s") == got["graph_capture"].seconds
    assert _read("copy_bytes_per_call") == 1000.0
