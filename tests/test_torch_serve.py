"""The port's slot-ring serving engine (``repro_torch.serve.ServeEngine``)
against the reference's (``repro.serve.ServeEngine``), on the CPU.

Both packages run one seeded reduced config (``qwen1.5-0.5b``, and
``mamba2-1.3b`` for the SSM slot reset); the reference's weights are
carried across by ``params_from_reference``.  Each scenario of the
reference's ``tests/test_serve.py`` runs on both engines: every request's
``out_tokens`` must be the reference's exactly, and the launch and queue
counters the same.  Then each behavioural test of the reference runs on
the port, and the port's own surface: the device and replay choice, the
graphed step (through a stand-in graph, as ``tests/test_torch_replay.py``
does; the real capture runs only on the card, in ``chip_smoke.py``), the
in-place SSM reset and ``python -m repro_torch.launch.serve``.
"""
import warnings
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro import serve as rserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch.core import executor
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import engine as tengine

#: the counters of ``stats()`` both engines keep and that must agree
COUNTERS = ("ticks", "tokens_generated", "requests_completed", "requests_rejected",
            "prefill_launches", "prefill_tokens", "decode_launches", "queue_depth")


def _pair(arch):
    rcfg = rconfigs.reduced_config(rconfigs.get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    rparams = rmodels.init_params(rcfg, 0)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, tcfg, rparams, tparams


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen1.5-0.5b")


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-1.3b")


@pytest.fixture(scope="module")
def small_model(qwen):
    """The port's side of ``qwen``: (config, parameters on the CPU)."""
    return qwen[1], qwen[3]


def _make(pair, side, **kw):
    """A function making engines for one side of a pair ("ref" or "port")."""
    rcfg, tcfg, rparams, tparams = pair
    if side == "ref":
        return lambda **k: rserve.ServeEngine(rcfg, rparams, **{**kw, **k})
    return lambda **k: tserve.ServeEngine(tcfg, tparams, device="cpu", **{**kw, **k})


def _req(S, rid, prompt, n):
    return S.Request(rid=rid, prompt=np.asarray(prompt, np.int32), max_new_tokens=n)


# ---------------------------------------------------- the reference's scenarios
def _single(S, make):
    eng = make(pool_size=2, max_len=64)
    r = _req(S, 0, [5, 9, 2], 6)
    eng.admit(r)
    eng.run_until_done()
    return eng, [r]


def _batched(S, make):
    eng = make(pool_size=2, max_len=64)
    reqs = [_req(S, 1, [3] * 6, 8), _req(S, 2, [5, 9, 2, 17], 5)]
    for r in reqs:
        eng.admit(r)
    eng.run_until_done()
    return eng, reqs


def _mid_stream(S, make):
    eng = make(pool_size=2, max_len=64)
    r1 = _req(S, 0, [1, 2, 3], 10)
    eng.admit(r1)
    eng.tick()
    eng.tick()
    r2 = _req(S, 1, [7, 8], 4)
    eng.admit(r2)
    eng.run_until_done()
    return eng, [r1, r2]


def _chunked(chunk):
    def run(S, make):
        eng = make(pool_size=2, max_len=64, prefill_chunk=chunk)
        r = _req(S, 0, [5, 9, 2, 17, 3, 8, 1], 5)
        eng.admit(r)
        eng.run_until_done()
        return eng, [r]
    return run


def _chunk_isolation(S, make):
    eng = make(pool_size=2, max_len=64, prefill_chunk=4)
    same = _req(S, 1, [5, 9, 2, 17], 6)
    eng.admit(same)
    eng.tick()
    late = _req(S, 2, [3, 3, 3, 3, 3], 4)
    eng.admit(late)
    eng.run_until_done()
    return eng, [same, late]


def _fifo(S, make):
    eng = make(pool_size=1, max_len=64, prefill_chunk=4)
    reqs = [_req(S, 0, [1, 2, 3], 2), _req(S, 1, [4, 5], 2), _req(S, 2, [6], 2)]
    for r in reqs:
        eng.admit(r)
    eng.run_until_done()
    return eng, reqs


def _retry_loop(S, make):
    eng = make(pool_size=1, max_len=64, prefill_chunk=4)
    reqs = [_req(S, 0, [1, 2], 3), _req(S, 1, [3, 4], 3)]
    ticks = 0
    while not all(r.done for r in reqs) and ticks < 50:
        for r in reqs:
            if not r.done:
                eng.admit(r)
        eng.tick()
        ticks += 1
    return eng, reqs


def _truncated(S, make):
    eng = make(pool_size=1, max_len=64, prefill_chunk=4)
    reqs = [_req(S, 0, [1, 2], 30), _req(S, 1, [3, 4], 30)]
    for r in reqs:
        eng.admit(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert eng.run_until_done(max_ticks=3) == 2
    eng.run_until_done()
    return eng, reqs


def _at_capacity(S, make):
    eng = make(pool_size=1, max_len=32, prefill_chunk=8)
    r = _req(S, 0, np.ones(31), 10)
    eng.admit(r)
    return eng, [r]


def _rejections(S, make):
    eng = make(pool_size=1, max_len=32)
    bad = _req(S, 0, np.ones(40), 4)
    for _ in range(3):
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            eng.admit(bad)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.admit(_req(S, 1, [], 4))
    r = _req(S, 2, [4, 5, 6], 3)
    eng.admit(r)
    eng.run_until_done()
    return eng, [r]


def _ssm_reuse(S, make):
    eng = make(pool_size=1, max_len=32, prefill_chunk=4)
    reqs = [_req(S, 1, [7, 8, 9], 5), _req(S, 2, [40, 41, 42, 43, 44], 5)]
    for r in reqs:
        eng.admit(r)
        eng.run_until_done()
    return eng, reqs


def _ssm_serves(S, make):
    eng = make(pool_size=2, max_len=32)
    r = _req(S, 0, [4, 4, 4], 4)
    eng.admit(r)
    eng.run_until_done()
    return eng, [r]


SCENARIOS = {
    "single": ("qwen", _single), "batched": ("qwen", _batched),
    "mid_stream": ("qwen", _mid_stream), "chunk1": ("qwen", _chunked(1)),
    "chunk4": ("qwen", _chunked(4)), "chunk16": ("qwen", _chunked(16)),
    "chunk_isolation": ("qwen", _chunk_isolation), "fifo": ("qwen", _fifo),
    "retry_loop": ("qwen", _retry_loop), "truncated": ("qwen", _truncated),
    "at_capacity": ("qwen", _at_capacity), "rejections": ("qwen", _rejections),
    "ssm_serves": ("mamba", _ssm_serves), "ssm_reuse": ("mamba", _ssm_reuse),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_matches_the_reference(name, request):
    """Every request's tokens exactly the reference's, and the counters."""
    model, scenario = SCENARIOS[name]
    pair = request.getfixturevalue(model)
    r_eng, r_reqs = scenario(rserve, _make(pair, "ref"))
    t_eng, t_reqs = scenario(tserve, _make(pair, "port"))
    assert [r.out_tokens for r in t_reqs] == [r.out_tokens for r in r_reqs]
    assert [r.done for r in t_reqs] == [r.done for r in r_reqs]
    rs, ts = r_eng.stats(), t_eng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert ts["prefill_chunk"] == rs["prefill_chunk"]


def test_step_logits_match_the_reference(qwen):
    """Under the tokens: the first decode step's logits at 2e-5 (f32)."""
    rcfg, tcfg, rparams, tparams = qwen
    toks = np.array([5, 9], np.int32)
    pos = np.array([0, 0], np.int32)
    want, _ = rmodels.decode_step(rparams, rmodels.init_cache(rcfg, 2, 16), toks, pos, rcfg)
    got, _ = tmodels.decode_step(tparams, tmodels.init_cache(tcfg, 2, 16, device="cpu"),
                                 torch.as_tensor(toks), torch.as_tensor(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------- the reference's behaviour, on the port
def _engine(small_model, **kw):
    cfg, params = small_model
    return tserve.ServeEngine(cfg, params, device="cpu", **kw)


def test_single_request_generates(small_model):
    cfg, _ = small_model
    eng = _engine(small_model, pool_size=2, max_len=64)
    req = tserve.Request(rid=0, prompt=np.array([5, 9, 2]), max_new_tokens=6)
    assert eng.admit(req)
    eng.run_until_done()
    assert req.done and len(req.out_tokens) == 6
    assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)


def test_batched_requests_independent(small_model):
    prompt = np.array([5, 9, 2, 17])
    solo = tserve.Request(rid=0, prompt=prompt, max_new_tokens=5)
    e1 = _engine(small_model, pool_size=2, max_len=64)
    e1.admit(solo)
    e1.run_until_done()
    e2 = _engine(small_model, pool_size=2, max_len=64)
    other = tserve.Request(rid=1, prompt=np.array([3, 3, 3, 3, 3, 3]), max_new_tokens=8)
    same = tserve.Request(rid=2, prompt=prompt, max_new_tokens=5)
    e2.admit(other)
    e2.admit(same)
    e2.run_until_done()
    assert same.out_tokens == solo.out_tokens


def test_continuous_batching_admits_mid_stream(small_model):
    eng = _engine(small_model, pool_size=2, max_len=64)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=10)
    eng.admit(r1)
    eng.tick()
    eng.tick()
    r2 = tserve.Request(rid=1, prompt=np.array([7, 8]), max_new_tokens=4)
    assert eng.admit(r2)
    eng.run_until_done()
    assert r1.done and r2.done
    assert len(r1.out_tokens) == 10 and len(r2.out_tokens) == 4


def test_pool_exhaustion_queues(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64)
    assert eng.admit(tserve.Request(rid=0, prompt=np.array([1]), max_new_tokens=50))
    assert not eng.admit(tserve.Request(rid=1, prompt=np.array([2]), max_new_tokens=2))


def test_chunked_prefill_token_parity(small_model):
    prompt = np.array([5, 9, 2, 17, 3, 8, 1])
    outs, launches = {}, {}
    for chunk in (1, 4, 16):
        eng = _engine(small_model, pool_size=2, max_len=64, prefill_chunk=chunk)
        req = tserve.Request(rid=0, prompt=prompt, max_new_tokens=5)
        assert eng.admit(req)
        eng.run_until_done()
        outs[chunk] = req.out_tokens
        launches[chunk] = eng.prefill_launches
    assert outs[1] == outs[4] == outs[16]
    assert (launches[1], launches[4], launches[16]) == (7, 2, 1)


def test_empty_and_over_capacity_prompts_rejected(small_model):
    eng = _engine(small_model, pool_size=1, max_len=32)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.admit(tserve.Request(rid=0, prompt=np.array([], dtype=np.int32)))
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        eng.admit(tserve.Request(rid=1, prompt=np.ones(32, np.int32)))
    assert eng.requests_rejected == 2
    assert not eng.wait_queue and eng.active_slots == []


def test_at_capacity_prompt_stops_after_first_token(small_model):
    eng = _engine(small_model, pool_size=1, max_len=32, prefill_chunk=8)
    req = tserve.Request(rid=0, prompt=np.ones(31, np.int32), max_new_tokens=10)
    assert eng.admit(req)
    assert req.done and len(req.out_tokens) == 1
    assert eng.active_slots == []


def test_wait_queue_admits_in_fifo_order(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64, prefill_chunk=4)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=2)
    r2 = tserve.Request(rid=1, prompt=np.array([4, 5]), max_new_tokens=2)
    r3 = tserve.Request(rid=2, prompt=np.array([6]), max_new_tokens=2)
    assert eng.admit(r1) is True
    assert eng.admit(r2) is False
    assert eng.admit(r3) is False
    assert list(eng.wait_queue) == [r2, r3]
    eng.run_until_done()
    assert r1.done and r2.done and r3.done
    assert r2.t_admit <= r3.t_admit
    assert not eng.wait_queue


def test_wait_queue_deduplicates_repeated_admit(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64)
    eng.admit(tserve.Request(rid=0, prompt=np.array([1]), max_new_tokens=8))
    r = tserve.Request(rid=1, prompt=np.array([2]), max_new_tokens=2)
    assert eng.admit(r) is False
    assert eng.admit(r) is False
    assert len(eng.wait_queue) == 1


def test_retry_loop_never_requeues_active_or_done_requests(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64, prefill_chunk=4)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2]), max_new_tokens=3)
    r2 = tserve.Request(rid=1, prompt=np.array([3, 4]), max_new_tokens=3)
    ticks = 0
    while not (r1.done and r2.done) and ticks < 50:
        for r in (r1, r2):
            if not r.done:
                eng.admit(r)
        eng.tick()
        ticks += 1
    assert eng.requests_completed == 2 and eng.tokens_generated == 6
    assert eng.admit(r2) is False
    assert not eng.wait_queue
    eng.run_until_done()
    assert len(r2.out_tokens) == 3 and eng.requests_completed == 2


def test_request_latency_stats_populated(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64, prefill_chunk=4)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2]), max_new_tokens=2)
    r2 = tserve.Request(rid=1, prompt=np.array([3, 4]), max_new_tokens=2)
    eng.admit(r1)
    eng.admit(r2)
    eng.run_until_done()
    for r in (r1, r2):
        assert r.ttft_s is not None and r.ttft_s >= 0
        assert r.latency_s is not None and r.latency_s >= r.ttft_s - 1e-9
        assert r.tokens_per_s and r.tokens_per_s > 0
    assert r2.queue_wait_s > 0
    st = eng.stats()
    assert st["requests_completed"] == 2
    assert st["prefill_launches"] == 2
    assert st["decode_launches"] == st["ticks"]


def test_run_until_done_reports_truncation(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64, prefill_chunk=4)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2]), max_new_tokens=30)
    r2 = tserve.Request(rid=1, prompt=np.array([3, 4]), max_new_tokens=30)
    eng.admit(r1)
    eng.admit(r2)
    with pytest.warns(RuntimeWarning, match="TRUNCATED"):
        assert eng.run_until_done(max_ticks=3) == 2
    with pytest.raises(RuntimeError, match="TRUNCATED"):
        eng.run_until_done(max_ticks=1, strict=True)
    assert eng.run_until_done() == 0
    assert r1.done and r2.done


def test_run_until_done_complete_returns_zero_no_warning(small_model):
    eng = _engine(small_model, pool_size=1, max_len=64, prefill_chunk=4)
    req = tserve.Request(rid=0, prompt=np.array([1, 2]), max_new_tokens=3)
    eng.admit(req)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert eng.run_until_done() == 0
    assert req.done


def test_rejected_request_counted_once_across_retries(small_model):
    eng = _engine(small_model, pool_size=1, max_len=32)
    bad = tserve.Request(rid=0, prompt=np.ones(40, np.int32))
    for _ in range(3):
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            eng.admit(bad)
    assert eng.requests_rejected == 1
    with pytest.raises(ValueError, match="empty prompt"):
        eng.admit(tserve.Request(rid=1, prompt=np.array([], dtype=np.int32)))
    assert eng.requests_rejected == 2


def test_ssm_slot_reuse_resets_recurrent_state_in_place(mamba):
    """A slot's second occupant decodes as if the first had never existed,
    and the reset zeroes the state where it lies: a captured graph reads
    those tensors, so the engine must never rebind them."""
    _, cfg, _, params = mamba
    prompt_b = np.array([40, 41, 42, 43, 44])
    solo = tserve.Request(rid=0, prompt=prompt_b, max_new_tokens=5)
    e1 = tserve.ServeEngine(cfg, params, pool_size=1, max_len=32, prefill_chunk=4, device="cpu")
    e1.admit(solo)
    e1.run_until_done()
    e2 = tserve.ServeEngine(cfg, params, pool_size=1, max_len=32, prefill_chunk=4, device="cpu")
    held = dict(e2.cache["mamba"])
    e2.admit(tserve.Request(rid=1, prompt=np.array([7, 8, 9]), max_new_tokens=5))
    e2.run_until_done()
    reused = tserve.Request(rid=2, prompt=prompt_b, max_new_tokens=5)
    e2.admit(reused)
    e2.run_until_done()
    assert reused.out_tokens == solo.out_tokens
    assert all(e2.cache["mamba"][k] is held[k] for k in held)


def test_decode_fn_returns_token_vector(small_model):
    cfg, params = small_model
    pool = 2
    fn, _ = tengine._decode_fn(cfg, pool)
    cache = tmodels.init_cache(cfg, pool, 16, device="cpu")
    toks, cache2 = fn(params, cache, torch.zeros(pool, dtype=torch.int32),
                      torch.zeros(pool, dtype=torch.int32), torch.ones(pool, dtype=torch.bool))
    assert cache2 is cache
    assert toks.shape == (pool,) and toks.dtype == torch.int32
    assert all(0 <= int(t) < cfg.vocab_size for t in toks)


def test_greedy_takes_the_first_of_tied_maxima(small_model):
    cfg, _ = small_model
    logits = torch.zeros((2, cfg.vocab_size + 3))
    logits[0, [3, 7]] = 1.0
    logits[1, cfg.vocab_size + 1] = 5.0        # padding past the vocab is never picked
    assert tengine._greedy(logits, cfg).tolist() == [3, 0]


def test_decode_cache_lru_bounded(small_model, monkeypatch):
    cfg, _ = small_model
    monkeypatch.setattr(tengine, "_DECODE_CACHE", OrderedDict())
    monkeypatch.setattr(tengine, "_DECODE_CACHE_CAP", 2)
    monkeypatch.setattr(tengine, "_DECODE_CACHE_EVICTIONS", 0)
    _, hit1 = tengine._decode_fn(cfg, 1)
    _, hit2 = tengine._decode_fn(cfg, 2)
    assert (hit1, hit2) == (False, False)
    _, hit1b = tengine._decode_fn(cfg, 1)
    assert hit1b is True
    tengine._decode_fn(cfg, 3)
    assert len(tengine._DECODE_CACHE) == 2
    assert tengine._DECODE_CACHE_EVICTIONS == 1
    _, hit2b = tengine._decode_fn(cfg, 2)
    assert hit2b is False
    _, hit1c = tengine._decode_fn(cfg, 1)
    assert hit1c is False
    assert tengine.decode_cache_stats()["evictions"] >= 2


def test_engines_share_the_step_function(small_model):
    e1 = _engine(small_model, pool_size=3, max_len=16)
    e2 = _engine(small_model, pool_size=3, max_len=16)
    assert e2.decode_cache_hit and e2._decode is e1._decode
    assert e2._steps[0] is not e1._steps[0]       # each engine its own step (and graph)


# ------------------------------------------------------ the device and replay
def test_default_engine_runs_eagerly_on_the_cpu(small_model):
    eng = _engine(small_model, pool_size=2, max_len=32, prefill_chunk=4)
    assert eng.replay is False and eng.device == torch.device("cpu")
    eng.admit(tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=3))
    eng.run_until_done()
    st = eng.stats()
    assert (st["graph_captures"], st["graph_replays"]) == (0, 0)
    assert set(st["graphs"]) == {"step", "chunk"}


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_replay_on_the_cpu_raises(small_model, engine):
    cfg, params = small_model
    cls = tserve.ServeEngine if engine == "slot" else tserve.PagedServeEngine
    with pytest.raises(RuntimeError, match="CUDA-graph replay runs on the card"):
        cls(cfg, params, device="cpu", replay=True)


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_engines_default_to_the_card(small_model, engine, monkeypatch):
    cfg, params = small_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = tserve.ServeEngine if engine == "slot" else tserve.PagedServeEngine
    with pytest.raises(RuntimeError, match="is_available"):
        cls(cfg, params)


def test_parameters_elsewhere_are_refused(small_model):
    cfg, _ = small_model
    with pytest.raises(ValueError, match="parameters lie on"):
        tserve.ServeEngine(cfg, tmodels.param_specs(cfg), device="cpu")


class _StandInGraph:
    """What a captured CUDA graph does, on the CPU: ``replay`` runs the
    captured step again and writes its token vector into the same static
    output.  Unlike a real capture, the stand-in's capture runs the step:
    on the dry batch (every row inactive), which must leave the state be."""

    def __init__(self, run, outs):
        self.run, self.outs, self.instantiated = run, outs, False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        for o, n in zip(self.outs, self.run(), strict=True):
            o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    captures = []

    def capture(run, device, keep_graph=False):
        assert keep_graph
        outs = run()
        captures.append(_StandInGraph(run, outs))
        return captures[-1], outs

    monkeypatch.setattr(executor, "_need_card", lambda device: torch.device(device))
    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(executor, "_capture_graph", capture)
    return captures


@pytest.mark.parametrize("model,scenario", [("qwen", "chunk_isolation"), ("qwen", "chunk1"),
                                            ("mamba", "ssm_reuse")])
def test_replayed_steps_give_the_eager_tokens(model, scenario, stand_in, request):
    """The graphed path (static buffers, dry warm-up and capture, replay)
    through a stand-in graph: the eager engine's tokens and counters, one
    capture a step kind, one replay a launch."""
    pair = request.getfixturevalue(model)
    run = SCENARIOS[scenario][1]
    e_eng, e_reqs = run(tserve, _make(pair, "port", replay=False))
    g_eng, g_reqs = run(tserve, _make(pair, "port", replay=True))
    assert [r.out_tokens for r in g_reqs] == [r.out_tokens for r in e_reqs]
    es, gs = e_eng.stats(), g_eng.stats()
    assert {k: gs[k] for k in COUNTERS} == {k: es[k] for k in COUNTERS}
    assert gs["graph_captures"] == len(g_eng._steps) == len(stand_in)
    assert gs["graph_replays"] == gs["prefill_launches"] + gs["decode_launches"]
    assert all(g["capture_s"] is not None for g in gs["graphs"].values())


def test_a_failed_capture_raises(small_model, stand_in, monkeypatch):
    def refuse(run, device, keep_graph=False):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(executor, "_capture_graph", refuse)
    eng = _engine(small_model, pool_size=2, max_len=32, prefill_chunk=4, replay=True)
    with pytest.raises(RuntimeError, match="not permitted when stream is capturing"):
        eng.admit(tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=3))


# ------------------------------------------------------------ the entry point
@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_launch_serve_finishes_every_request(engine, capsys):
    rc = tlaunch.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--engine", engine,
                       "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "3/3 done (0 unfinished)" in out and "replay=False" in out


@pytest.mark.parametrize("engine", ["paged", "slot"])
@pytest.mark.parametrize("flags,replay", [([], True), (["--no-replay"], False)])
def test_launch_serve_no_replay_runs_the_steps_eagerly(engine, flags, replay, stand_in,
                                                        monkeypatch, capsys):
    """Where replay is the default (the card; here the stand-in graph),
    ``--no-replay`` gives the eager engine: no capture and no replay."""
    monkeypatch.setattr(tengine, "_replay_mode",
                        lambda dev, r: True if r is None else bool(r))
    rc = tlaunch.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--engine", engine,
                       "--requests", "3", "--max-new", "4", *flags])
    out = capsys.readouterr().out
    assert rc == 0 and "3/3 done (0 unfinished)" in out and f"replay={replay}" in out
    assert ("graphs captured=0 replays=0" in out) is not replay
    assert len(stand_in) == (2 if replay else 0)


def test_launch_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tlaunch.main(["--arch", "qwen1.5-0.5b", "--requests", "1"])
