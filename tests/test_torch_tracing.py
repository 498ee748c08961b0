"""The port's tracer (``repro_torch.tracing``): spans, their nesting and call
ids, the ring, counters; the spans a stitched function's compile and calls
record on the CPU, and the fields filled from them; the profiler's ranges;
the replay's copy bytes (through a stand-in for the CUDA graph here, and
on the card by the ``card`` test); the build's span and counters; and the
fusion labels of the generated kernels' symbols.

On the card (``--noconftest``: the tests' ``conftest.py`` imports jax,
which this file does not need):
``PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_tracing.py``.
"""
import hashlib
import re
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import stitch, tracing
from repro_torch.core import cuda_build, executor
from repro_torch.core.codegen import LABEL_CHARS, fusion_label
from repro_torch.core.ir import Instruction


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _layer(x, g, w):
    h = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g
    return x + torch.tanh(h @ w)


def _args(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    return [t.to(device) for t in (torch.randn(16, 32, generator=gen),
                                   torch.randn(32, generator=gen),
                                   torch.randn(32, 32, generator=gen))]


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


# ------------------------------------------------------------------ tracer
def test_spans_nest_share_their_call_and_give_self_time():
    t = tracing.Tracer()
    with t.span("call", function="f") as outer:
        with t.span("compile"):
            with t.span("capture"):
                pass
        with t.span("execute", mode="eager") as inner:
            inner.attrs["late"] = 1
    with t.span("call"):
        pass
    spans = t.snapshot().spans
    assert [s.name for s in spans] == ["capture", "compile", "execute", "call", "call"]
    cap, comp, ex, call, call2 = spans
    assert call.parent == 0 and call.call == call.id == outer.id
    assert comp.parent == call.id and cap.parent == comp.id and ex.parent == call.id
    assert {s.call for s in spans[:4]} == {call.id} and call2.call == call2.id != call.id
    assert ex.attrs == {"mode": "eager", "late": 1} and call.attrs == {"function": "f"}
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert call.seconds == outer.seconds == (call.end_ns - call.start_ns) / 1e9
    own = tracing.self_seconds(spans)
    assert own[call.id] == pytest.approx(call.seconds - comp.seconds - ex.seconds)
    assert own[comp.id] == pytest.approx(comp.seconds - cap.seconds)
    assert own[cap.id] == cap.seconds


def test_the_ring_keeps_the_newest_spans_and_counters_add_until_reset():
    t = tracing.Tracer(ring=4)
    for k in range(10):
        with t.span(f"s{k}"):
            pass
    assert [s.name for s in t.snapshot().spans] == ["s6", "s7", "s8", "s9"]
    t.count("replay.calls", 1)
    t.count("replay.calls", 2)
    t.count("replay.copy_bytes", 1 << 40)
    assert t.snapshot().counters == {"replay.calls": 3, "replay.copy_bytes": 1 << 40}
    t.reset()
    assert t.snapshot() == ([], {})
    with t.span("after"):
        pass
    assert [s.name for s in t.snapshot().spans] == ["after"]


def test_threads_nest_their_own_spans_and_lose_no_count():
    t = tracing.Tracer()
    threads, rounds = 16, 400
    errors = []

    def work(k):
        try:
            for _ in range(rounds):
                with t.span(f"outer{k}") as o:
                    with t.span(f"inner{k}") as i:
                        t.count("n", 1)
                    if i.parent != o.id or i.call != o.call:
                        errors.append((k, i.parent, o.id))
        except Exception as e:       # reported below, with the thread's index
            errors.append((k, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers) and errors == []
    snap = t.snapshot()
    assert snap.counters == {"n": threads * rounds}
    outer = {s.id: s for s in snap.spans if s.name.startswith("outer")}
    for s in snap.spans:
        if s.name.startswith("inner"):
            assert outer[s.parent].name == "outer" + s.name[5:]


# ------------------------------------------------------ the port's spans
def test_a_cpu_compile_records_its_phases_and_fills_its_fields_from_them():
    tracing.reset()
    sf = stitch(_layer, device="cpu")
    sf(*_args())
    sf(*_args())
    spans = tracing.snapshot().spans
    (comp,) = _by_name(spans, "compile")
    calls = _by_name(spans, "call")
    kernels = [k.fn.symbol for k in sf._last.compiled.kernels]
    assert len(calls) == 2 and comp.parent == calls[0].id
    assert comp.attrs == {"function": "_layer", "arguments": len(_args()), "kernels": kernels}
    (cap,), (low,), (cm,) = (_by_name(spans, n) for n in ("capture", "lower", "compile_module"))
    assert cap.parent == low.parent == cm.parent == comp.id
    passes = [s for s in spans if s.name.startswith("pass.")]
    assert [s.name for s in passes] == ["pass." + n for n in sf.stats.pass_times if n != "verify"]
    assert "pass.fusion" in {s.name for s in passes} and all(s.parent == cm.id for s in passes)
    (ver,) = _by_name(spans, "verify")
    assert ver.parent == cm.id
    execs = _by_name(spans, "execute")
    assert [e.parent for e in execs] == [c.id for c in calls]
    assert all(e.attrs == {"mode": "eager"} for e in execs)
    # every span of a call shares its call id
    assert {s.call for s in spans if s.start_ns < calls[0].end_ns} == {calls[0].id}
    # the fields the benchmark and chip_smoke.py read are the spans' durations
    assert sf.capture_s == cap.seconds and sf.lower_s == low.seconds
    assert sf.stats.compile_time_s == cm.seconds
    assert sf.stats.pass_times == {**{s.name[5:]: s.seconds for s in passes},
                                   "verify": ver.seconds}
    assert not _by_name(spans, "build") and not _by_name(spans, "graph_capture")
    assert sf.stats.build_time_s == 0.0


def test_the_profiler_sees_each_span_with_the_same_nesting():
    from torch.profiler import ProfilerActivity, profile

    sf = stitch(_layer, device="cpu")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sf(*_args())                          # the compile and the first call
    spans = tracing.snapshot().spans
    assert {"call", "compile", "capture", "pass.fusion", "execute"} <= {s.name for s in spans}
    events = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert sorted(e.name for e in events) == sorted("repro_torch." + s.name for s in spans)
    event = {e.name: e for e in events}       # each name once in this call
    span = {s.id: s for s in spans}
    for s in spans:
        parent = event["repro_torch." + s.name].cpu_parent
        if s.parent:
            assert parent is not None and parent.name == "repro_torch." + span[s.parent].name
        else:
            assert parent is None


def test_no_profiler_range_opens_without_a_session(monkeypatch):
    opened = []

    class Recording:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_Range", Recording)
    sf = stitch(_layer, device="cpu")
    sf(*_args())
    assert opened == []
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)
    with tracing.span("call"):
        with tracing.span("execute"):
            pass
    assert opened == ["repro_torch.call", "repro_torch.execute"]


# ------------------------------------------------------- the replay's copies
def _feeds_and_roots_nbytes(sf, args):
    out = sf(*args)
    return sum(a.nbytes for a in args) + out.nbytes


def test_a_plan_copies_its_feeds_and_roots_bytes():
    sf = stitch(_layer, device="cpu")
    args = _args()
    want = _feeds_and_roots_nbytes(sf, args)
    g = sf._last.compiled.executable.execution_plan._graph
    assert g.copy_bytes == want == (16 * 32 + 32 + 32 * 32 + 16 * 32) * 4
    assert len(g.feed_slots) == 3 and len(g.out_slots) == 1


def test_each_replay_counts_its_copy_bytes(monkeypatch):
    """The replay through a stand-in for the CUDA graph: ``graph_capture``
    once, inside the first ``execute``; each replay adds one call and the
    plan's copy bytes."""

    class StandIn:
        def __init__(self, run, outs):
            self.run, self.outs = run, outs

        def replay(self):
            for o, n in zip(self.outs, self.run(), strict=True):
                o.copy_(n)

    def capture(run, device):
        outs = run()
        return StandIn(run, outs), outs

    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(executor, "_capture_graph", capture)
    sf = stitch(_layer, device="cpu")
    args = _args()
    eager = sf(*args)
    ep = sf._last.compiled.executable.execution_plan
    tracing.reset()
    feeds = dict(zip(sf._last.lowered.param_names, args, strict=True))
    for _ in range(3):
        (got,) = ep.replay(feeds).values()
        torch.testing.assert_close(got, eager, rtol=0, atol=0)
    snap = tracing.snapshot()
    assert snap.counters == {"replay.calls": 3, "replay.copy_bytes": 3 * ep._graph.copy_bytes}
    execs = _by_name(snap.spans, "execute")
    (cap,) = _by_name(snap.spans, "graph_capture")
    assert [e.attrs["mode"] for e in execs] == ["graph"] * 3 and cap.parent == execs[0].id


@pytest.mark.card
def test_a_replay_on_the_card_counts_its_copy_bytes(card):
    """The plan's CUDA-graph replay on the card (``replay``, whatever its
    ``replay_mode``): each replay adds one call and the plan's copy bytes;
    its spans are host ranges of the profiler alone, none on the device's
    timeline."""
    from torch.profiler import ProfilerActivity, profile

    sf = stitch(_layer)
    args = _args(card)
    eager = sf(*args)
    want = sum(a.nbytes for a in args) + eager.nbytes
    ep = sf._last.compiled.executable.execution_plan
    assert ep._graph.copy_bytes == want
    feeds = dict(zip(sf._last.lowered.param_names, args, strict=True))
    before = tracing.snapshot().counters
    ep.replay(feeds)                          # the capture, outside the profiled calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            (got,) = ep.replay(feeds).values()
        torch.cuda.synchronize()
    torch.testing.assert_close(got, eager, rtol=1e-5, atol=1e-5)
    after = tracing.snapshot().counters
    assert after["replay.calls"] - before.get("replay.calls", 0) == 5
    assert after["replay.copy_bytes"] - before.get("replay.copy_bytes", 0) == 5 * want
    assert _by_name(tracing.snapshot().spans, "graph_capture")
    assert any(s.name == "build" for s in tracing.snapshot().spans)
    cuda = torch.autograd.DeviceType.CUDA
    ours = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert [e.name for e in ours] == ["repro_torch.execute"] * 4
    assert all(e.device_type != cuda for e in ours)
    assert any(e.device_type == cuda and "stitch_" in e.name for e in prof.events())


# ------------------------------------------------------------------ builds
_FAKE_NVCC = """#!/bin/sh
for a; do last=$a; done
while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done
exec g++ -shared -fPIC -x c++ -o "$out" "$last"
"""


def test_a_build_span_says_whether_nvcc_ran(tmp_path, monkeypatch):
    """``cuda_build.load`` through a stand-in nvcc (the host's C++ compiler):
    the first load compiles, the second finds the library built."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to stand in for nvcc")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    source = 'extern "C" int sx_answer(void) { return 42; }\n'
    tracing.reset()
    lib, first_s = cuda_build.load(source)
    assert lib.sx_answer() == 42
    _, again_s = cuda_build.load(source)
    snap = tracing.snapshot()
    builds = _by_name(snap.spans, "build")
    assert [b.attrs for b in builds] == [{"source_bytes": len(source), "nvcc": True},
                                         {"source_bytes": len(source), "nvcc": False}]
    assert [first_s, again_s] == [b.seconds for b in builds]
    assert snap.counters == {"build.nvcc": 1, "build.found": 1}


# ------------------------------------------------------------------ labels
def _members(*tags):
    return [Instruction("elementwise", (2,), np.float32, attrs={"fn": t}) for t in tags]


def test_a_label_is_the_distinct_ops_in_order_that_fit_its_length():
    assert fusion_label(_members("mul", "exp", "mul", "add")) == "mul_exp_add"
    red = Instruction("reduce", (2,), np.float32, attrs={"kind": "sum"})
    bc = Instruction("broadcast", (2,), np.float32)
    assert fusion_label([bc, red, bc]) == "broadcast_sum"
    long = fusion_label(_members("a" * 20, "b" * 11, "c" * 5))
    assert long == "a" * 20 + "_" + "b" * 11 and len(long) == LABEL_CHARS
    # an op that does not fit is left out, a later one that fits is kept
    assert fusion_label(_members("a" * 20, "b" * 12, "c" * 5)) == "a" * 20 + "_ccccc"
    odd = fusion_label(_members("Weird-Op.Name" * 4))
    assert re.fullmatch(r"[a-z0-9_]{1,32}", odd) and odd.startswith("weird_op_name")


def test_a_kernel_symbol_carries_its_label_and_its_name_stays():
    sf = stitch(_layer, device="cpu")
    sf(*_args())
    cm = sf._last.compiled
    kernels = {k.fn.name: k for k in cm.executable.kernels.values()}
    assert kernels
    for name, k in kernels.items():
        label = fusion_label(k.fusion.members)
        assert re.fullmatch(r"stitch_[0-9a-f]{16}", name)
        assert re.fullmatch(r"[a-z0-9_]{1,32}", label)
        assert k.fn.symbol == f"{name}_{label}"
        src = k.fn.source
        assert re.search(rf"__global__ void __launch_bounds__\(\d+\) {k.fn.symbol}\(", src)
        assert f'extern "C" int {name}_launch(' in src
        assert f"{k.fn.symbol}<<<" in src or f"cudaLaunchCooperativeKernel({k.fn.symbol}," in src
        # the name is the hash of the text before the symbol went in
        text = src.replace(f"{name}_launch", "@K@_launch").replace(k.fn.symbol, "@K@")
        assert name == "stitch_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    # the same function compiled again: the same names and symbols
    again = stitch(_layer, device="cpu")
    again(*_args())
    assert {k.fn.name: k.fn.symbol for k in again._last.compiled.executable.kernels.values()} \
        == {n: k.fn.symbol for n, k in kernels.items()}
