"""The port's paged continuous batching (``repro_torch.serve``: the block
allocator, the scheduler, the traffic harness and ``PagedServeEngine``)
against the reference's ``repro.serve``, on the CPU.

The allocator and the scheduler (under a fake clock) are driven through
the same seeded sequences of calls on both packages and must decide alike,
call for call; ``generate_trace`` must give the reference's entries.  The
engines run the reference's bursty trace
(``test_bursty_trace_liveness_and_no_block_leak``) on one seeded reduced
config, the reference's weights carried across: identical tokens per
request, ticks, launches, preemptions, KV block stats and ``TrafficReport``
counts (everything but the times).  Then paged against slot and
preemption-resume parity inside the port, as the reference's tests check
them, the hybrid and SSM families' paged paths, and the graphed paged step
through a stand-in graph.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro import serve as rserve
from repro.serve import scheduler as rsched
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch.core import executor
from repro_torch.serve import scheduler as tsched

#: ``stats()`` keys that are the port's own (graphs) or process-wide (the
#: step cache); every other key must equal the reference's
PORT_KEYS = ("graph_captures", "graph_replays", "graphs", "decode_cache")
#: ``TrafficReport`` fields that are wall-clock times
TIMES = ("duration_s", "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "latency_p50_ms",
         "latency_p99_ms", "queue_wait_p50_ms", "queue_wait_p99_ms")


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
def small_model(qwen):
    return qwen[1], qwen[3]


def _paged(small_model, **kw):
    cfg, params = small_model
    return tserve.PagedServeEngine(cfg, params, device="cpu", **kw)


def _slot(small_model, **kw):
    cfg, params = small_model
    return tserve.ServeEngine(cfg, params, device="cpu", **kw)


def _same_stats(got, want):
    got = {k: v for k, v in got.items() if k not in PORT_KEYS}
    want = {k: v for k, v in want.items() if k != "decode_cache"}
    assert got == want


# ---------------------------------------------------------- allocator
def test_blocks_for_tokens_matches_the_reference():
    for n in range(0, 70):
        for bs in (1, 4, 16):
            for ring in (8, 32, 64):
                assert tserve.blocks_for_tokens(n, bs, ring) == rserve.blocks_for_tokens(n, bs, ring)


def _drive_allocator(S, seed):
    """A seeded run of alloc/free/can_alloc calls, recording every answer
    and error and the stats after each call."""
    rng = np.random.RandomState(seed)
    a = S.BlockAllocator(num_blocks=12, block_size=4)
    held, log = [], []
    for _ in range(200):
        op = rng.randint(4)
        try:
            if op == 0:
                n = int(rng.randint(1, 6))
                got = a.alloc(n)
                log.append(("alloc", n, got))
                if got is not None:
                    held.append(got)
            elif op == 1 and held:
                blocks = held.pop(int(rng.randint(len(held))))
                a.free(blocks)
                log.append(("free", blocks))
            elif op == 2:
                n = int(rng.randint(0, 14))
                log.append(("can_alloc", n, a.can_alloc(n)))
            else:
                bad = [int(rng.randint(0, 14))]
                a.free(bad)
                log.append(("free", bad))
        except RuntimeError as e:
            log.append(("error", str(e)))
        log.append((a.stats(), a.num_free, a.num_in_use, a.utilization))
    a.check_consistent()
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_decides_as_the_reference(seed):
    assert _drive_allocator(tserve, seed) == _drive_allocator(rserve, seed)


def test_allocator_alloc_free_roundtrip():
    a = tserve.BlockAllocator(num_blocks=4, block_size=8)
    got = a.alloc(3)
    assert got == [0, 1, 2]                     # LIFO free list: ascending ids first
    assert a.num_free == 1 and a.num_in_use == 3
    assert a.alloc(2) is None                   # all-or-nothing
    assert a.alloc_failures == 1 and a.num_free == 1
    a.free(got)
    assert a.num_free == 4 and a.num_in_use == 0
    a.check_consistent()
    assert a.stats()["peak_in_use"] == 3
    with pytest.raises(ValueError, match="positive"):
        tserve.BlockAllocator(0, 4)


def test_allocator_double_free_raises():
    a = tserve.BlockAllocator(num_blocks=2, block_size=4)
    got = a.alloc(1)
    a.free(got)
    with pytest.raises(RuntimeError, match="double free|not allocated"):
        a.free(got)
    with pytest.raises(RuntimeError, match="not allocated"):
        a.free([99])
    a.check_consistent()


# ---------------------------------------------------------- scheduler
SLOS = {
    "none": {},
    "decode": {"decode_slo_s": 0.5},
    "ttft": {"ttft_slo_s": 1.0, "safety": 0.8},
    "both": {"ttft_slo_s": 0.6, "decode_slo_s": 0.3, "safety": 0.9},
}


def _drive_scheduler(S, mod, slo, seed):
    """A seeded run of choose/observe/enqueue/requeue calls under a fake
    clock, recording every decision and the stats after each call."""
    rng = np.random.RandomState(seed)
    t = [0.0]
    s = S.Scheduler(S.SLOConfig(**slo) if slo else None, clock=lambda: t[0])
    log = []
    for i in range(300):
        t[0] += float(rng.uniform(0, 0.3))
        op = rng.randint(4)
        if op == 0:
            wait = float(rng.uniform(0, 1.5)) if rng.rand() < 0.7 else None
            log.append(s.choose(int(rng.randint(3)), int(rng.randint(3)), wait,
                                int(rng.randint(4))))
        elif op == 1:
            action = (mod.PREFILL_ACTION, mod.DECODE_ACTION)[rng.randint(2)]
            s.observe_launch(action, float(rng.uniform(0.01, 0.4)))
        elif op == 2:
            s.enqueue(i)
        else:
            s.requeue_front(i)
        log.append((s.stats(), list(s.waiting), s.last_action, s.ema_prefill_s, s.ema_decode_s))
    return log


@pytest.mark.parametrize("slo", list(SLOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decides_as_the_reference(slo, seed):
    got = _drive_scheduler(tserve, tsched, SLOS[slo], seed)
    assert got == _drive_scheduler(rserve, rsched, SLOS[slo], seed)


def test_scheduler_alternates_without_slo():
    clock = iter(float(i) for i in range(1000))
    s = tserve.Scheduler(clock=lambda: next(clock))
    assert s.choose(0, 0) == tsched.IDLE_ACTION
    assert s.choose(1, 0) == tsched.PREFILL_ACTION
    assert s.choose(0, 1) == tsched.DECODE_ACTION
    seq = [s.choose(1, 1) for _ in range(4)]
    assert seq == [tsched.PREFILL_ACTION, tsched.DECODE_ACTION, tsched.PREFILL_ACTION,
                   tsched.DECODE_ACTION]


def test_scheduler_slo_overrides():
    t = [0.0]
    s = tserve.Scheduler(tserve.SLOConfig(decode_slo_s=0.5), clock=lambda: t[0])
    assert s.choose(1, 1) == tsched.PREFILL_ACTION
    t[0] = 0.1
    assert s.choose(1, 1) == tsched.DECODE_ACTION
    t[0] = 1.0
    assert s.choose(1, 1) == tsched.DECODE_ACTION
    assert s.decode_overrides == 1
    s = tserve.Scheduler(tserve.SLOConfig(ttft_slo_s=1.0, safety=0.8), clock=lambda: 0.0)
    s.observe_launch(tsched.PREFILL_ACTION, 0.2)
    assert s.choose(1, 1) == tsched.PREFILL_ACTION
    assert s.choose(1, 1) == tsched.DECODE_ACTION
    assert s.choose(1, 1, oldest_prefill_wait_s=0.7, chunks_remaining=2) == tsched.PREFILL_ACTION
    assert s.ttft_overrides == 1


def test_slo_config_validation():
    with pytest.raises(ValueError, match="ttft_slo_s"):
        tserve.SLOConfig(ttft_slo_s=-1.0)
    with pytest.raises(ValueError, match="safety"):
        tserve.SLOConfig(safety=0.0)


# ----------------------------------------------------- traffic harness
TRACES = [
    dict(num_requests=16, arrival="poisson", seed=7),
    dict(num_requests=32, arrival="bursty", burst_size=12, burst_gap_ticks=8.0,
         prompt_len_lo=3, prompt_len_hi=10, max_new_lo=3, max_new_hi=8, vocab_size=256, seed=3),
    dict(num_requests=16, arrival="poisson", mean_interarrival_ticks=2, prompt_len_lo=16,
         prompt_len_hi=64, max_new_lo=8, max_new_hi=16, vocab_size=49155, seed=0),
]


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_generate_trace_gives_the_reference_entries(i):
    got = tserve.generate_trace(tserve.TraceConfig(**TRACES[i]))
    want = rserve.generate_trace(rserve.TraceConfig(**TRACES[i]))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert (g.rid, g.arrive_tick, g.max_new_tokens) == (w.rid, w.arrive_tick, w.max_new_tokens)
        assert g.prompt.dtype == w.prompt.dtype and np.array_equal(g.prompt, w.prompt)


def test_trace_config_validation():
    with pytest.raises(ValueError, match="arrival"):
        tserve.TraceConfig(arrival="adversarial")
    with pytest.raises(ValueError, match="num_requests"):
        tserve.TraceConfig(num_requests=0)


# ------------------------------------------------- engine against the reference
BURSTY = dict(num_requests=32, arrival="bursty", burst_size=12, burst_gap_ticks=8.0,
              prompt_len_lo=3, prompt_len_hi=10, max_new_lo=3, max_new_hi=8, seed=3)
BURSTY_ENGINE = dict(decode_width=8, max_len=32, block_size=4, num_blocks=16, prefill_chunk=4)


def _bursty(S, cfg, params, **kw):
    trace = S.generate_trace(S.TraceConfig(vocab_size=cfg.vocab_size, **BURSTY))
    eng = S.PagedServeEngine(cfg, params, **BURSTY_ENGINE, **kw)
    reqs = {}
    admit = eng.admit

    def keep(req):            # run_trace makes the requests: keep them for their tokens
        reqs[req.rid] = req
        return admit(req)

    eng.admit = keep
    rep = S.run_trace(eng, trace, max_ticks=20_000, strict=True)
    return eng, rep, {rid: r.out_tokens for rid, r in reqs.items()}


def test_bursty_trace_matches_the_reference(qwen):
    rcfg, tcfg, rparams, tparams = qwen
    r_eng, r_rep, r_toks = _bursty(rserve, rcfg, rparams)
    t_eng, t_rep, t_toks = _bursty(tserve, tcfg, tparams, device="cpu")
    assert t_toks == r_toks and len(t_toks) == 32
    assert t_eng.sched.preemptions == r_eng.sched.preemptions > 0
    _same_stats(t_eng.stats(), r_eng.stats())
    counts = [f.name for f in dataclasses.fields(rserve.TrafficReport) if f.name not in TIMES]
    assert {k: getattr(t_rep, k) for k in counts} == {k: getattr(r_rep, k) for k in counts}
    t_eng.allocator.check_consistent()
    assert t_eng.allocator.num_in_use == 0


def test_bursty_trace_liveness_and_no_block_leak(small_model):
    cfg, params = small_model
    tc = tserve.TraceConfig(vocab_size=cfg.vocab_size, **BURSTY)
    eng = _paged(small_model, **BURSTY_ENGINE)
    rep = tserve.run_trace(eng, tserve.generate_trace(tc), max_ticks=20_000, strict=True)
    assert rep.completed == rep.total == 32 and rep.unfinished == 0
    eng.allocator.check_consistent()
    st = eng.allocator.stats()
    assert st["in_use"] == 0 and st["allocated_total"] == st["freed_total"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_other_families_paged_match_the_reference_and_the_slot_engine(arch):
    """SSM rows (no KV blocks at all) and the hybrid sliding-window family
    (block tables over a ring smaller than max_len): the port's paged
    engine gives the reference's paged tokens and its own slot engine's."""
    rcfg, tcfg, rparams, tparams = _pair(arch)
    prompt = np.arange(1, 10, dtype=np.int32)
    kw = dict(decode_width=2, max_len=32, block_size=4, prefill_chunk=4)
    outs, stats = {}, {}
    for name, S, cfg, params, extra in (("ref", rserve, rcfg, rparams, {}),
                                        ("port", tserve, tcfg, tparams, {"device": "cpu"})):
        eng = S.PagedServeEngine(cfg, params, **kw, **extra)
        req = S.Request(rid=0, prompt=prompt, max_new_tokens=6)
        eng.admit(req)
        assert eng.run_until_done() == 0
        outs[name], stats[name] = req.out_tokens, eng.stats()
    _same_stats(stats["port"], stats["ref"])
    slot = tserve.ServeEngine(tcfg, tparams, pool_size=2, max_len=32, prefill_chunk=4, device="cpu")
    oracle = tserve.Request(rid=0, prompt=prompt, max_new_tokens=6)
    slot.admit(oracle)
    slot.run_until_done()
    assert outs["port"] == outs["ref"] == oracle.out_tokens


# ----------------------------------------------------- parity inside the port
def test_paged_matches_slot_engine_single_request(small_model):
    for plen, chunk in ((1, 4), (3, 4), (7, 4), (12, 8), (17, 4)):
        prompt = (np.arange(plen) % 100 + 1).astype(np.int32)
        oracle = tserve.Request(rid=0, prompt=prompt, max_new_tokens=6)
        e1 = _slot(small_model, pool_size=2, max_len=32, prefill_chunk=chunk)
        e1.admit(oracle)
        e1.run_until_done()
        req = tserve.Request(rid=0, prompt=prompt, max_new_tokens=6)
        e2 = _paged(small_model, decode_width=2, max_len=32, block_size=4, prefill_chunk=chunk)
        e2.admit(req)
        assert e2.run_until_done() == 0
        assert req.out_tokens == oracle.out_tokens, (plen, chunk)


def test_preemption_resume_token_parity(small_model):
    p1 = np.arange(1, 13, dtype=np.int32)
    p2 = np.arange(20, 32, dtype=np.int32)
    solo = {}
    for i, p in enumerate((p1, p2)):
        e = _slot(small_model, pool_size=1, max_len=32, prefill_chunk=4)
        r = tserve.Request(rid=i, prompt=p, max_new_tokens=16)
        e.admit(r)
        e.run_until_done()
        solo[i] = r.out_tokens
    eng = _paged(small_model, decode_width=2, max_len=32, block_size=4, num_blocks=8,
                 prefill_chunk=4)
    ra = tserve.Request(rid=0, prompt=p1, max_new_tokens=16)
    rb = tserve.Request(rid=1, prompt=p2, max_new_tokens=16)
    eng.admit(ra)
    eng.admit(rb)
    assert eng.run_until_done(max_ticks=1000) == 0
    assert eng.sched.preemptions > 0
    assert ra.out_tokens == solo[0] and rb.out_tokens == solo[1]
    eng.allocator.check_consistent()
    assert eng.allocator.num_in_use == 0


def test_paged_batch_isolation(small_model):
    prompt = np.array([5, 9, 2, 17], np.int32)
    solo = tserve.Request(rid=0, prompt=prompt, max_new_tokens=5)
    e1 = _paged(small_model, decode_width=4, max_len=32, block_size=4, prefill_chunk=4)
    e1.admit(solo)
    e1.run_until_done()
    e2 = _paged(small_model, decode_width=4, max_len=32, block_size=4, prefill_chunk=4)
    for i in (1, 2):
        e2.admit(tserve.Request(rid=i, prompt=np.full(6, 3 + i, np.int32), max_new_tokens=8))
    same = tserve.Request(rid=3, prompt=prompt, max_new_tokens=5)
    e2.admit(same)
    e2.run_until_done()
    assert same.out_tokens == solo.out_tokens


def test_paged_mid_stream_admission(small_model):
    eng = _paged(small_model, decode_width=2, max_len=32, block_size=4, prefill_chunk=4)
    r1 = tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=10)
    eng.admit(r1)
    eng.tick()
    eng.tick()
    r2 = tserve.Request(rid=1, prompt=np.array([7, 8]), max_new_tokens=4)
    assert eng.admit(r2)
    assert eng.run_until_done() == 0
    assert len(r1.out_tokens) == 10 and len(r2.out_tokens) == 4


def test_single_request_pool_floor_enforced(small_model):
    with pytest.raises(ValueError, match="cannot hold even one"):
        _paged(small_model, decode_width=2, max_len=32, block_size=4, num_blocks=5)
    with pytest.raises(ValueError, match="decode_width must be positive"):
        _paged(small_model, decode_width=0)


def test_paged_fifo_admission_order(small_model):
    eng = _paged(small_model, decode_width=1, max_len=32, block_size=4, num_blocks=8,
                 prefill_chunk=4)
    reqs = [
        tserve.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=3),
        tserve.Request(rid=1, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=3),
        tserve.Request(rid=2, prompt=np.array([1], np.int32), max_new_tokens=3),
    ]
    assert eng.admit(reqs[0]) is True
    assert eng.admit(reqs[1]) is False
    assert eng.admit(reqs[2]) is False
    assert eng.run_until_done() == 0
    assert reqs[0].t_first <= reqs[1].t_first <= reqs[2].t_first
    assert all(len(r.out_tokens) == 3 for r in reqs)


def test_paged_rejection_and_truncation(small_model):
    eng = _paged(small_model, decode_width=2, max_len=32, block_size=4, prefill_chunk=4)
    bad = tserve.Request(rid=0, prompt=np.ones(40, np.int32))
    for _ in range(3):
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            eng.admit(bad)
    assert eng.requests_rejected == 1
    slow = tserve.Request(rid=1, prompt=np.array([1, 2]), max_new_tokens=25)
    eng.admit(slow)
    with pytest.warns(RuntimeWarning, match="TRUNCATED"):
        assert eng.run_until_done(max_ticks=2) == 1
    with pytest.raises(RuntimeError, match="TRUNCATED"):
        eng.run_until_done(max_ticks=1, strict=True)
    assert eng.run_until_done() == 0 and slow.done


def test_paged_concurrency_exceeds_slot_pool(small_model):
    cfg, _ = small_model
    tc = tserve.TraceConfig(num_requests=24, arrival="bursty", burst_size=24, prompt_len_lo=3,
                            prompt_len_hi=6, max_new_lo=3, max_new_hi=4,
                            vocab_size=cfg.vocab_size, seed=4)
    trace = tserve.generate_trace(tc)
    pr = tserve.run_trace(_paged(small_model, decode_width=8, max_len=32, block_size=4,
                                 num_blocks=16, prefill_chunk=4), trace, strict=True)
    sr = tserve.run_trace(_slot(small_model, pool_size=2, max_len=32, prefill_chunk=4), trace,
                          strict=True)
    assert pr.completed == sr.completed == 24
    assert pr.max_inflight >= 4 * sr.max_inflight


def test_traffic_report_fields(small_model):
    cfg, _ = small_model
    tc = tserve.TraceConfig(num_requests=8, arrival="poisson", mean_interarrival_ticks=0.5,
                            prompt_len_lo=2, prompt_len_hi=5, max_new_lo=2, max_new_hi=3,
                            vocab_size=cfg.vocab_size, seed=5)
    eng = _paged(small_model, decode_width=4, max_len=32, block_size=4, prefill_chunk=4)
    rep = tserve.run_trace(eng, tserve.generate_trace(tc), max_ticks=5_000, strict=True)
    assert rep.completed == rep.total == 8
    assert rep.tokens_out > 0 and rep.tokens_per_s > 0
    assert rep.ttft_p50_ms <= rep.ttft_p99_ms and rep.latency_p50_ms <= rep.latency_p99_ms
    assert 1 <= rep.max_inflight <= 4
    assert "done in" in rep.summary()


def test_paged_engine_stats_shape(small_model):
    eng = _paged(small_model, decode_width=2, max_len=32, block_size=4, prefill_chunk=4)
    eng.admit(tserve.Request(rid=0, prompt=np.array([1, 2, 3]), max_new_tokens=3))
    eng.run_until_done()
    st = eng.stats()
    assert st["requests_completed"] == 1 and st["tokens_generated"] == 3
    assert st["kv_blocks"]["in_use"] == 0
    assert st["kv_blocks"]["freed_total"] == st["kv_blocks"]["allocated_total"]
    assert st["scheduler"]["admitted"] == 1 and st["max_inflight"] == 1
    assert (st["graph_captures"], st["graph_replays"]) == (0, 0)
    assert isinstance(eng, tserve.BaseEngine)


def test_whisper_has_no_paged_engine():
    cfg = tconfigs.reduced_config(tconfigs.get_config("whisper-base"))
    params = tmodels.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="audio family"):
        tserve.PagedServeEngine(cfg, params, decode_width=2, max_len=32, block_size=4,
                                device="cpu")


# ------------------------------------------------------- the graphed paged step
class _StandInGraph:
    """A captured graph on the CPU: ``replay`` runs the step again into the
    same static output (``tests/test_torch_serve.py`` says more)."""

    def __init__(self, run, outs):
        self.run, self.outs = run, outs

    def instantiate(self):
        pass

    def replay(self):
        for o, n in zip(self.outs, self.run(), strict=True):
            o.copy_(n)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b"])
def test_replayed_paged_steps_give_the_eager_tokens(arch, monkeypatch):
    """Preemption, recompute and the parking block under the graphed path:
    the dry warm-up and capture write only the parking block (and leave the
    hybrid's recurrent rows be), so tokens and counters are the eager ones."""
    _, cfg, _, params = _pair(arch)
    monkeypatch.setattr(executor, "_need_card", lambda device: torch.device(device))
    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())

    def capture(run, device, keep_graph=False):
        outs = run()
        return _StandInGraph(run, outs), outs

    monkeypatch.setattr(executor, "_capture_graph", capture)
    runs = {}
    for replay in (False, True):
        eng = tserve.PagedServeEngine(cfg, params, decode_width=2, max_len=32, block_size=4,
                                      num_blocks=8, prefill_chunk=4, device="cpu", replay=replay)
        reqs = [tserve.Request(rid=i, prompt=np.arange(1 + 20 * i, 13 + 20 * i, dtype=np.int32),
                               max_new_tokens=16) for i in range(2)]
        for r in reqs:
            eng.admit(r)
        assert eng.run_until_done(max_ticks=1000) == 0
        runs[replay] = (eng.stats(), [r.out_tokens for r in reqs])
    (es, etoks), (gs, gtoks) = runs[False], runs[True]
    assert gtoks == etoks
    _same_stats(gs, {k: v for k, v in es.items() if k not in PORT_KEYS})
    assert gs["graph_captures"] == 2
    assert gs["graph_replays"] == gs["prefill_launches"] + gs["decode_launches"]
