"""A configuration, a traffic mix, a metric and a cell added as files and
entries are found by name, with no edit to the harness."""
import json
import shutil

import torch

from stitchbench import harness
from stitchbench_cells import BENCH


def _tree(tmp_path):
    """A copy of the benchmark's data beside a ``BENCHMARK.json`` with one
    more configuration, traffic mix, end-to-end metric and cell."""
    root = tmp_path / "stitchbench"
    for kind in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(harness.HERE / kind, root / kind)
    cfg = json.loads((root / "configs" / "granite-moe-3b-a800m.attn.json").read_text())
    cfg.update(name="tiny.attn", hidden_size=32, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, num_hidden_layers=2)
    (root / "configs" / "tiny.attn.json").write_text(json.dumps(cfg))
    (root / "traffic" / "burst-16.json").write_text(json.dumps(
        {"batch": 3, "seq": 16, "distinct_inputs": 2}))
    (root / "metrics" / "calls.made.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    (root / "metrics" / "never_read.py").write_text("def read(run):\n    return None\n")
    (root / "limits" / "tiny.attn.burst-16.json").write_text(json.dumps(
        {"limits": {"out_err": {"limit": 1e-3}}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny.attn", "source": "test", "reduced": [],
                             "file": "stitchbench/configs/tiny.attn.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.attn.burst-16", "config": "tiny.attn",
                               "traffic": "burst-16", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls.made", "unit": "calls", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.attn.burst-16"]})
    bench["per_layer"].append({"name": "never_read", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "test", "moves": "calls.made",
                               "workloads": ["tiny.attn.burst-16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_files_are_found_by_name(tmp_path):
    root = _tree(tmp_path)
    cell = harness.load_cell("tiny.attn.burst-16", root=root)
    assert cell.config["hidden_size"] == 32 and (cell.batch, cell.seq) == (3, 16)
    assert [m["name"] for m in cell.metrics] == ["tokens_per_s", "setup_s", "calls.made"]
    assert "never_read" in [m["name"] for m in cell.per_layer]
    assert cell.limits["out_err"]["limit"] == 1e-3
    old = harness.load_cell("mistral-large-123b.tp8.prefill-2k", root=root)
    assert "calls.made" not in [m["name"] for m in old.metrics]
    assert "never_read" not in [m["name"] for m in old.per_layer]


def test_a_new_cell_runs_and_reads_its_new_metric(tmp_path):
    import time

    cell = harness.load_cell("tiny.attn.burst-16", root=_tree(tmp_path))
    result, _ = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert result["metrics"]["calls.made"] == {"value": float(result["attempted"]),
                                               "unit": "calls"}
    traced, _ = harness.run_cell(cell, 5, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert "never_read" not in traced["metrics"]
    assert result["correct"] and traced["correct"]


def test_per_layer_metrics_follow_the_end_to_end_metric_they_move():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "ttft_only", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x", "moves": "ttft_ms"})
    cell = harness.load_cell("granite-moe-3b-a800m.attn.prefill-4k", bench)
    assert "ttft_only" not in [m["name"] for m in cell.per_layer]
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in BENCH["per_layer"]}
