"""Loops (``call``/``get``) in the port against the reference.

Each loop module of ``repro_torch.graphs.LOOP_GRAPHS`` is built twice, by
the reference's ``GraphBuilder.call_loop`` and by the port's, and the same
seeded numpy feeds go through the reference's ``compile_module`` and
``reference_execute`` and the port's, on the CPU, at the reference suite's
2e-5.  The loop accounting (``loop_calls``, ``sub_compiles``,
``sub_call_sites``, ``sub_kernels``) must equal the reference's.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import StitchOptions, compile_module, reference_execute, verify_module
from repro_torch.core.interop import module_from_reference
from repro_torch.core.ir import apply_op
from repro_torch.graphs import LOOP_GRAPHS, rnn_graph

TOL = 2e-5


def _feeds(module, seed=0):
    rng = np.random.RandomState(seed)
    return {p.name: (rng.randn(*p.shape) * 0.3).astype(np.float32) for p in module.parameters}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL, err_msg=what)


def _loop_stats(stats):
    return (stats.loop_calls, stats.sub_compiles, stats.sub_call_sites, stats.sub_kernels,
            stats.stitched_kernels, stats.standalone_kernels, stats.library_calls)


@pytest.mark.parametrize("name", list(LOOP_GRAPHS))
@pytest.mark.parametrize("planner", ["cost", "greedy"])
def test_loop_matches_the_reference(name, planner):
    build = LOOP_GRAPHS[name]
    ref_module, port_module = build(builder=R.GraphBuilder), build()
    feeds = _feeds(ref_module)
    ref = R.compile_module(ref_module, R.StitchOptions(planner=planner))
    port = compile_module(port_module, StitchOptions(planner=planner), device="cpu")
    assert _loop_stats(port.stats) == _loop_stats(ref.stats)
    got, oracle = port(feeds), reference_execute(port_module, feeds, device="cpu")
    want, want_oracle = ref(feeds), R.reference_execute(ref_module, feeds)
    # roots pair by position: names carry each package's own instruction counter
    pairs = list(zip([r.name for r in port_module.roots], [r.name for r in ref_module.roots],
                     strict=True))
    assert set(got) == set(oracle) == {p for p, _ in pairs} and set(want) == {r for _, r in pairs}
    for k, rk in pairs:
        _close(got[k].numpy(), np.asarray(want[rk]), f"{name}:{k} vs repro compile_module")
        _close(oracle[k].numpy(), np.asarray(want_oracle[rk]), f"{name}:{k} vs repro reference_execute")


def test_rnn_scan_compiles_to_one_loop_of_one_kernel():
    port = compile_module(LOOP_GRAPHS["RNNScan"](), StitchOptions(), device="cpu")
    s = port.stats
    assert (s.loop_calls, s.sub_compiles, s.sub_kernels) == (1, 1, 1)
    (step,) = port.executable.execution_plan.steps
    assert step.trip == 6 and step.body_plan.stats.eager_dispatches_per_call == 3
    assert s.eager_dispatches_per_call == 6 * 3         # 2 library dots + 1 kernel a step


def test_rnn_scan_final_state_is_the_unrolled_graphs():
    """The loop's final hidden state equals the unrolled RNN graph's, whose
    last cell output feeds its logits."""
    scan = LOOP_GRAPHS["RNNScan"]()
    feeds = _feeds(scan)
    out = compile_module(scan, StitchOptions(), device="cpu")(feeds)
    h_final, hs = (out[r.name] for r in scan.roots)
    unrolled = rnn_graph()
    ufeeds = {k: feeds[k] for k in ("Wx", "Wh", "b", "h0")}
    ufeeds.update({f"x{t}": feeds["xs"][t] for t in range(6)})
    ufeeds["Wo"] = np.eye(32, 8, dtype=np.float32)
    vals = {}
    for instr in unrolled.instructions:
        vals[instr.id] = (torch.as_tensor(ufeeds[instr.name]) if instr.opcode == "parameter"
                          else apply_op(instr, *[vals[o.id] for o in instr.operands]))
    wo = next(i for i in unrolled.instructions if i.name == "Wo")
    h_unrolled = vals[next(u for u in wo.users).operands[0].id]
    torch.testing.assert_close(h_final, h_unrolled, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hs[-1], h_final, rtol=0, atol=0)


def test_two_identical_scans_share_one_compiled_body():
    port = compile_module(LOOP_GRAPHS["TwoScans"](), StitchOptions(), device="cpu")
    assert (port.stats.loop_calls, port.stats.sub_compiles, port.stats.sub_call_sites) == (2, 1, 2)
    a, b = port.executable.execution_plan.steps
    assert a.body_plan is b.body_plan


def test_reverse_scan_stacks_ys_in_iteration_order():
    m = LOOP_GRAPHS["ReverseScan"]()
    feeds = _feeds(m)
    out = compile_module(m, StitchOptions(), device="cpu")(feeds)
    c, want = feeds["init"].copy(), []
    for t in reversed(range(5)):
        c = c * np.float32(0.9) + feeds["xs"][t]
        want.append(c - feeds["xs"][t])
    final, ys = (out[r.name] for r in m.roots)
    _close(final.numpy(), c, "final carry")
    _close(ys.numpy(), np.stack(want[::-1]), "stacked ys")


def test_carried_loop_module_keeps_its_body():
    ref_module = LOOP_GRAPHS["DecodeLoop"](builder=R.GraphBuilder)
    R.compile_module(ref_module, R.StitchOptions())     # leaves compiled_body on the call
    port_module = module_from_reference(ref_module)
    call = next(i for i in port_module.instructions if i.opcode == "call")
    assert "compiled_body" not in call.attrs and "body_sig" not in call.attrs
    body = call.attrs["body"]
    assert [i.opcode for i in body.instructions] == [
        i.opcode for i in ref_module.instructions[2].attrs["body"].instructions]
    assert verify_module(port_module) == []
    feeds = _feeds(ref_module)
    got = compile_module(port_module, StitchOptions(), device="cpu")(feeds)
    want = R.reference_execute(ref_module, feeds)
    for k in want:
        _close(got[k].numpy(), np.asarray(want[k]), k)


def test_zero_trip_loop_gives_empty_ys():
    m = LOOP_GRAPHS["DecodeLoop"](steps=0)
    feeds = _feeds(m)
    out = compile_module(m, StitchOptions(), device="cpu")(feeds)
    final, ys = (out[r.name] for r in m.roots)
    assert tuple(ys.shape) == (0, 4) and torch.equal(final, torch.as_tensor(feeds["h"]))
