"""The result line's keys, the readers over a synthetic trace, the check on
loaded modules, and the refusals of ``run.py``."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from stitchbench import harness, trace, work
from stitchbench_cells import WORKLOADS, small_cell

ROOT = harness.HERE.parent


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    cell = small_cell(WORKLOADS[0])
    result, info = harness.run_cell(cell, 2**31 + 99, 1.0, traced, torch.device("cpu"),
                                    time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if traced else ["checks"]
    assert list(result) == keys
    json.dumps(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    names = [m["name"] for m in (cell.per_layer if traced else cell.metrics)]
    assert set(result["metrics"]) <= set(names)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "compile_s" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}
    assert set(result["checks"]) == {"out_err"}
    assert set(result["checks"]["out_err"]) == {"value", "limit"}
    assert set(info) >= {"setup", "plan"}


def _run(events, calls=2, span=(0.0, 100.0), layers=1):
    cell = small_cell(WORKLOADS[0])
    r = harness.Run(cell=cell, work=work.Work(tokens=10, gemm_flops=67e6, gemm_bytes=0.0,
                                              fused_flops=0.0, fused_flops_dense=0.0,
                                              fused_bytes=3.35e6), layers=layers)
    r.events, r.calls = events, calls
    r.device_window_s = (span[1] - span[0]) / 1e6
    r.busy_s = trace.busy_us(events, span) / 1e6
    return r


def _read(name, run):
    return harness._module(harness.HERE, "metrics", name).read(run)


def test_readers_over_a_synthetic_trace():
    # per call: a 2 µs GEMM (1 µs at the roofline), a 4 µs generated kernel
    # (1 µs of bytes at the roofline), a 1 µs copy; overlapping copies
    ev = [(0.0, "sm90_xmma_gemm_f32f32", 2.0), (2.0, "stitch_ab12", 4.0),
          (6.0, "Memcpy DtoD (Device -> Device)", 1.0), (6.5, "Memcpy DtoD (Device -> Device)", 1.0),
          (50.0, "ampere_sgemm_128x64", 2.0), (52.0, "stitch_ab12", 4.0)]
    r = _run(ev)
    assert _read("kernels_per_call", r) == 3.0
    assert _read("gemm_roofline", r) == pytest.approx(50.0)
    assert _read("fused_roofline", r) == pytest.approx(25.0)
    assert r.busy_s == pytest.approx(13.5e-6)
    assert _read("idle_share", r) == pytest.approx(86.5)
    # 67 MFLOP a request in 50 µs a request at 67 TFLOP/s
    assert _read("mfu", r) == pytest.approx(2.0)
    assert trace.idle_gaps(ev, (0.0, 100.0)) == [(7.5, 42.5), (56.0, 44.0)]
    # the same two requests of two layers each: kernels are counted a layer
    assert _read("kernels_per_call", _run(ev, layers=2)) == 1.5


def test_a_bf16_request_is_held_to_the_tensor_cores_peak():
    ev = [(0.0, "sm90_xmma_gemm_bf16bf16", 2.0), (50.0, "sm90_xmma_gemm_bf16bf16", 2.0)]
    r = _run(ev)
    r.work = work.Work(tokens=10, gemm_flops=989e6, gemm_bytes=0.0, fused_flops=0.0,
                       fused_flops_dense=0.0, fused_bytes=0.0,
                       peak_flops=work.PEAK_FLOPS["bfloat16"])
    assert _read("gemm_roofline", r) == pytest.approx(50.0)
    assert _read("mfu", r) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["kernels_per_call", "gemm_roofline", "fused_roofline",
                                  "idle_share", "mfu"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert _read(name, _run([])) is None


def test_between_marks_keeps_what_ran_between_two_marks():
    pad, mark = trace.PAD_KERNEL, trace.PAD_KERNEL
    ev = [(0.0, pad, 1.0), (2.0, "stitch_x", 1.0), (3.0, mark, 100.0), (104.0, "k1", 1.0),
          (106.0, "k2", 1.0), (108.0, mark, 100.0), (209.0, pad, 1.0)]
    sel, span, edges = trace.between_marks(ev)
    assert [n for _, n, _ in sel] == ["k1", "k2"]
    assert span == (103.0, 108.0)
    assert edges == {"pads": [1, 1], "marks": 2}
    sel, span, edges = trace.between_marks(ev[:3])
    assert sel is None and span is None and edges["marks"] == 1


def test_kernel_classes():
    assert trace.is_gemm("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32")
    assert trace.is_gemm("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>")
    assert trace.is_gemm("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT")
    assert not trace.is_gemm("stitch_3fa9c1")
    assert trace.is_copy("Memcpy DtoD (Device -> Device)") and trace.is_copy("Memset (Device)")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_extra", "reprox", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    for name in ("repro.core.ir", "jaxlib", "flax.linen", "jax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == ["flax.linen", "jax", "jaxlib", "repro.core.ir"]


def test_the_harness_loads_no_forbidden_module():
    code = ("import sys, time; sys.path[:0] = [%r, %r]; import torch;"
            "from stitchbench import harness; from stitchbench_cells import small_cell;"
            "c = small_cell(%r); harness.run_cell(c, 3, 0.1, False, torch.device('cpu'),"
            " time.perf_counter()); print(harness.forbidden_modules())"
            % (str(ROOT), str(ROOT / "src"), WORKLOADS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(__file__), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "stitchbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "stitchbench", tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "stitchbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
