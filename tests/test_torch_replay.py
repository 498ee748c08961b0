"""The port's CUDA-graph replay (``jit_replay``), as far as it runs without a
card: the plan's segments and dispatch accounting on the ten graphs, the
eager loop kept by ``jit_replay=False`` and by the CPU, slot release, feed
validation, and the replay machinery itself (static inputs, outputs copied
out of the graph's pool, launch counters) driven through a stand-in for
``torch.cuda.CUDAGraph`` that re-runs the captured steps.  The real capture
and its bitwise parity with the eager loop are checked on the card by
``chip_smoke.py``.  Mirrors ``tests/test_runtime_replay.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import GraphBuilder, StitchOptions, codegen, compile_module, executor, trace
from repro_torch.graphs import ALL_GRAPHS, LOOP_GRAPHS, random_feeds

GRAPHS = {**ALL_GRAPHS, **LOOP_GRAPHS}


def _compile(name, **kw):
    return compile_module(GRAPHS[name](), StitchOptions(max_blocks=64, **kw), device="cpu")


def _feeds(comp, seed=0):
    return random_feeds(comp.executable.module, np.random.RandomState(seed))


class _StandInGraph:
    """What a captured CUDA graph does, on the CPU: ``replay`` runs the
    captured steps again and writes their results into the same static
    output tensors.  Launch counters do not tick during a replay (a graph
    launch goes through no Python wrapper)."""

    counting = True

    def __init__(self, run, outs):
        self.run, self.outs, self.replays = run, outs, 0

    def replay(self):
        _StandInGraph.counting = False
        try:
            for o, n in zip(self.outs, self.run(), strict=True):
                o.copy_(n)
        finally:
            _StandInGraph.counting = True
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """Replay on the CPU through ``_StandInGraph``; every plain kernel call
    ticks its program's launch counter as a launch on the card would."""
    captures = []

    def capture(run, device):
        outs = run()
        captures.append(_StandInGraph(run, outs))
        return captures[-1], outs

    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(executor, "_capture_graph", capture)
    plain_call = codegen.KernelProgram.__call__

    def counting_call(self, *args, device=None):
        if _StandInGraph.counting:
            self.launches += 1
        return plain_call(self, *args, device=device)

    monkeypatch.setattr(codegen.KernelProgram, "__call__", counting_call)
    return captures


# ------------------------------------------------------- plan and accounting
@pytest.mark.parametrize("name", list(GRAPHS))
def test_dispatch_accounting(name):
    comp = _compile(name)
    ep, s = comp.executable.execution_plan, comp.stats
    seg = ep._graph                           # every step captures: one graph
    assert seg.steps == ep.steps
    loops = [st for st in ep.steps if type(st) is executor._LoopStep]
    assert s.eager_dispatches_per_call == len(ep.steps) - len(loops) + sum(
        st.trip * st.body_plan.stats.eager_dispatches_per_call for st in loops)
    # one graph launch, and the copies of the feeds into its static inputs
    # and of the roots out of its pool: the small ones batched by dtype, a
    # large one (StitchPipe's 512 x 320 x and root) on its own
    assert sorted(seg.feed_slots) == [slot for _, slot, _, _ in ep._param_binds
                                      if any(slot in st.arg_slots for st in ep.steps)]
    module = comp.executable.module
    by_name = {i.name: i for i in module.parameters + module.roots}
    of_slot = {slot: by_name[n] for n, slot, _, _ in ep._param_binds}
    of_slot.update((s_, by_name[n]) for n, s_ in ep._root_binds)
    assert s.traced_dispatches_per_call == 1 + sum(
        len(executor._copy_groups([of_slot[x] for x in slots]))
        for slots in (seg.feed_slots, seg.out_slots))
    assert (seg.in_groups, seg.out_groups) == (
        executor._copy_groups([of_slot[x] for x in seg.feed_slots]),
        executor._copy_groups([of_slot[x] for x in seg.out_slots]))
    if name == "W2V":        # f32 and int32 feeds: a batch of each dtype
        assert s.traced_dispatches_per_call == 4
    if name == "StitchPipe":
        assert s.traced_dispatches_per_call == 4     # graph, x, g, the root
    assert s.replay_dispatch_reduction == s.eager_dispatches_per_call - s.traced_dispatches_per_call
    assert s.loop_calls == len(loops)


def test_default_options_replay_on_the_card_only():
    assert StitchOptions().jit_replay is True
    comp = _compile("Stacked")
    assert comp.stats.replay_mode == "eager"           # the CPU's path
    ex = comp.executable
    ex.execution_plan.device = torch.device("cuda")
    assert ex.replay_mode == "graph"
    ex.jit_replay = False
    assert ex.replay_mode == "eager"


#: the graphs a replayed call would dispatch more for than an eager one
#: (one kernel, plus its feed and root copies): they run eager by default
EAGER_BY_DISPATCHES = {"W2V", "NMT", "ReduceTowers", "BcastHeavy", "StitchPipe"}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_replay_mode_follows_the_dispatch_counts(name):
    """The mode is fixed at plan time from the plan's own counts: replay
    where it dispatches no more than the eager loop (a tie replays)."""
    comp = _compile(name)
    ex, s = comp.executable, comp.stats
    ex.execution_plan.device = torch.device("cuda")
    want = "eager" if name in EAGER_BY_DISPATCHES else "graph"
    assert (s.replay_dispatch_reduction < 0) == (want == "eager")
    assert ex.replay_mode == want


def test_an_eager_mode_plan_still_replays_on_request(stand_in):
    comp = _compile("NMT")
    ex = comp.executable
    ex.execution_plan.device = torch.device("cuda")
    assert ex.replay_mode == "eager"
    feeds = _feeds(comp)
    ex.execution_plan.device = torch.device("cpu")
    eager, traced = ex.execute_eager(feeds), ex.jit_execute(feeds)
    assert len(stand_in) == 1
    for k in eager:
        assert torch.equal(eager[k], traced[k])


@pytest.mark.parametrize("jit_replay", [True, False])
def test_call_routing(jit_replay, monkeypatch):
    comp = _compile("Stacked", jit_replay=jit_replay)
    ex, calls = comp.executable, []
    ex.execution_plan.device = torch.device("cuda")
    monkeypatch.setattr(ex.execution_plan, "replay", lambda feeds: calls.append("graph"))
    monkeypatch.setattr(ex.execution_plan, "execute", lambda feeds: calls.append("eager"))
    ex({})
    assert calls == ["graph" if jit_replay else "eager"]


def test_cpu_takes_no_capture(monkeypatch):
    def refuse(run, device):
        raise AssertionError("a CPU call must not capture")

    monkeypatch.setattr(executor, "_capture_graph", refuse)
    monkeypatch.setattr(executor, "_warm_up", refuse)
    comp = _compile("RNN")
    comp(_feeds(comp))
    st = comp.executable.launch_stats()
    assert st.eager_calls == 1 and st.traced_calls == 0 and st.graph_captures == 0


def test_replay_refuses_the_cpu_without_a_card():
    comp = _compile("LR")
    with pytest.raises(RuntimeError, match="runs on the card"):
        comp.executable.jit_execute(_feeds(comp))


# ------------------------------------------------------- the replay itself
@pytest.mark.parametrize("name", list(GRAPHS))
def test_replay_matches_the_eager_loop_bit_for_bit(name, stand_in):
    comp = _compile(name)
    ex = comp.executable
    feeds = _feeds(comp)
    eager = ex.execute_eager(feeds)
    first = ex.jit_execute(feeds)
    second = ex.jit_execute(feeds)
    assert len(stand_in) == 1 and stand_in[0].replays == 2
    for k in eager:
        assert torch.equal(eager[k], first[k]) and torch.equal(eager[k], second[k]), k
    st = ex.launch_stats()
    assert st.traced_calls == 2 and st.eager_calls == 1 and st.graph_captures == 1


def test_results_the_caller_holds_stay_valid(stand_in):
    comp = _compile("Stacked")
    ex = comp.executable
    f1, f2 = _feeds(comp, 0), _feeds(comp, 1)
    out1 = ex.jit_execute(f1)
    held = {k: v.clone() for k, v in out1.items()}
    out2 = ex.jit_execute(f2)
    for k in out1:
        assert torch.equal(out1[k], held[k]), "a result changed under the next call"
        assert not torch.equal(out1[k], out2[k])
        assert torch.equal(out2[k], ex.execute_eager(f2)[k])
    seg = ex.execution_plan._graph
    # the roots are copies, not the graph's static outputs
    assert all(all(o.data_ptr() != s.data_ptr() for s in seg.static_out) for o in out2.values())


def test_feeds_reach_the_graph_through_its_static_inputs(stand_in):
    comp = _compile("LR")
    ep = comp.executable.execution_plan
    f1 = _feeds(comp, 0)
    ep.replay(f1)
    seg = ep._graph
    ptrs = [t.data_ptr() for t in seg.static_in]
    f2 = _feeds(comp, 1)
    ep.replay(f2)
    assert [t.data_ptr() for t in seg.static_in] == ptrs
    slot_feed = {slot: name for name, slot, _, _ in ep._param_binds}
    for slot, t in zip(seg.feed_slots, seg.static_in, strict=True):
        np.testing.assert_array_equal(t.numpy(), f2[slot_feed[slot]])
        assert t.is_contiguous()


def test_launch_counters_count_each_replay_once(stand_in):
    comp = _compile("Stacked")
    ex = comp.executable
    programs = {id(k.fn): k.fn for k in ex.kernels.values()}
    launches_per_pass = {pid: sum(1 for k in ex.kernels.values() if id(k.fn) == pid)
                         for pid in programs}
    for p in programs.values():
        p.launches = 0
    feeds = _feeds(comp)
    ex.jit_execute(feeds)     # the warm-up launches, the capture does not, the replay does
    assert {pid: p.launches for pid, p in programs.items()} == {
        pid: 2 * n for pid, n in launches_per_pass.items()}
    ex.jit_execute(feeds)
    assert {pid: p.launches for pid, p in programs.items()} == {
        pid: 3 * n for pid, n in launches_per_pass.items()}
    seg = ex.execution_plan._graph
    assert sorted((id(p), n) for p, n in seg.ticks) == sorted(launches_per_pass.items())


def test_a_failed_capture_raises_naming_its_step(stand_in, monkeypatch):
    comp = _compile("StitchPipe")
    ex = comp.executable
    (k,) = {id(k.fn): k for k in ex.kernels.values()}.values()
    calls = []

    def fail_in_capture(self, *args, device=None):
        calls.append(1)
        if len(calls) > 1:      # the warm-up passes, the capture fails
            raise RuntimeError("operation not permitted when stream is capturing")
        return k.fn.plain(*args, device=device)

    monkeypatch.setattr(codegen.KernelProgram, "__call__", fail_in_capture)
    with pytest.raises(RuntimeError, match=f"CUDA-graph capture failed at kernel {k.fn.name}"):
        ex.jit_execute(_feeds(comp))
    assert ex.launch_stats().traced_calls == 0


# ----------------------------------------------------------- slot release
def _leaked(ep):
    root_slots = {s for _, s in ep._root_binds}
    released = [s for step in ep.steps for s in step.release]
    assert len(released) == len(set(released)), "slot released twice"
    written = set()
    for step in ep.steps:
        written.update(executor._step_outs(step))
    return written - set(released) - root_slots


@pytest.mark.parametrize("name", list(GRAPHS))
def test_slots_are_released_and_the_pool_takes_only_what_the_graph_made(name):
    ep = _compile(name).executable.execution_plan
    assert not _leaked(ep)
    seg = ep._graph
    protected = {slot for _, slot, _, _ in ep._param_binds} | {
        s for s, v in enumerate(ep._template) if v is not None}
    assert not seg.pool_released & protected
    assert seg.pool_released <= {s for step in ep.steps for s in step.release}
    assert not seg.pool_released & set(seg.out_slots)


# -------------------------------------------------------- feed validation
@pytest.mark.parametrize("runner", ["execute_eager", "jit_execute"])
def test_missing_feed_raises_named_error(runner, stand_in):
    comp = _compile("LR")
    feeds = _feeds(comp)
    missing = sorted(feeds)[0]
    del feeds[missing]
    with pytest.raises(KeyError, match=f"missing feed for parameter {missing}"):
        getattr(comp.executable, runner)(feeds)


@pytest.mark.parametrize("runner", ["execute_eager", "jit_execute"])
def test_bad_feed_shape_raises(runner, stand_in):
    comp = _compile("LR")
    feeds = _feeds(comp)
    feeds[sorted(feeds)[0]] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="feed shape"):
        getattr(comp.executable, runner)(feeds)


def test_multi_root_builder_graph_parity(stand_in):
    """A hand-built two-sink module: both replays agree bit for bit."""
    def f(b, x, y):
        s = b.tanh(x + y)
        t = b.reduce(s, (1,), "sum")
        u = b.exp(b.broadcast(t, (16, 16), (0,)) - s)
        return s * 2.0, u

    module = trace(f, ("x", (16, 16), np.float32), ("y", (16, 16), np.float32))
    comp = compile_module(module, StitchOptions(max_blocks=64), device="cpu")
    feeds = random_feeds(module, np.random.RandomState(0))
    eager = comp.executable.execute_eager(feeds)
    traced = comp.executable.jit_execute(feeds)
    assert len(eager) >= 2
    for k in eager:
        assert torch.equal(eager[k], traced[k])


def test_roots_no_step_makes_come_back_as_in_the_eager_loop(stand_in):
    """A parameter nothing reads and a constant nothing reads are roots the
    graph does not make: the replay returns them as the eager loop does,
    and copies only the root the graph made."""
    b = GraphBuilder("edge")
    x = b.parameter("x", (4, 8), np.float32)
    b.parameter("unused", (3,), np.float32)
    b.constant(np.arange(3, dtype=np.float32))
    b.tanh(x)
    comp = compile_module(b.module, StitchOptions(), device="cpu")
    feeds = {"x": np.ones((4, 8), np.float32), "unused": np.zeros(3, np.float32)}
    eager = comp.executable.execute_eager(feeds)
    traced = comp.executable.jit_execute(feeds)
    assert len(traced) == 3
    for k in eager:
        assert torch.equal(eager[k], traced[k]), k
    ep = comp.executable.execution_plan
    assert len(ep._graph.out_slots) == 1 and comp.stats.traced_dispatches_per_call == 3
