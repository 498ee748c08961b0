"""Traffic-trace generation and replay for the serving engines: the
reference's ``repro/serve/traffic.py``, copied (host code).  Traces come
from numpy's ``default_rng(seed)``, so a seeded trace gives the
reference's entries.

A trace is a deterministic (seeded) list of requests with tick-indexed
arrival times — Poisson for steady load, or bursty (Poisson bursts of
back-to-back arrivals) to stress admission, queueing and preemption.
Arrivals are in TICK units, not wall-clock, so a replay is scheduling-
deterministic: the same trace against the same engine admits the same
requests at the same ticks regardless of host speed.  Wall-clock enters
only through the latency stamps (TTFT / latency percentiles).

``run_trace`` drives any engine exposing ``admit / tick / busy /
inflight`` (both the slot-ring and the paged engine do), which is how the
benchmark compares the two under identical offered load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from .engine import Request


@dataclasses.dataclass
class TraceConfig:
    """Knobs for a synthetic request trace (all randomness seeded)."""
    num_requests: int = 64
    arrival: str = "poisson"          # "poisson" | "bursty"
    mean_interarrival_ticks: float = 1.0   # poisson: mean gap between arrivals
    burst_size: int = 8               # bursty: requests per burst
    burst_gap_ticks: float = 12.0     # bursty: mean gap between bursts
    prompt_len_lo: int = 4            # prompt lengths ~ U[lo, hi]
    prompt_len_hi: int = 12
    max_new_lo: int = 4               # generation budgets ~ U[lo, hi]
    max_new_hi: int = 8
    vocab_size: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.num_requests <= 0:
            raise ValueError("num_requests must be positive")
        if not (0 < self.prompt_len_lo <= self.prompt_len_hi):
            raise ValueError("need 0 < prompt_len_lo <= prompt_len_hi")
        if not (0 < self.max_new_lo <= self.max_new_hi):
            raise ValueError("need 0 < max_new_lo <= max_new_hi")


@dataclasses.dataclass
class TraceEntry:
    rid: int
    arrive_tick: int
    prompt: np.ndarray
    max_new_tokens: int


def generate_trace(cfg: TraceConfig) -> List[TraceEntry]:
    rng = np.random.default_rng(cfg.seed)
    # arrival ticks first, so prompt sampling never perturbs timing
    if cfg.arrival == "poisson":
        gaps = rng.exponential(cfg.mean_interarrival_ticks, cfg.num_requests)
        ticks = np.floor(np.cumsum(gaps)).astype(int)
    else:  # bursty: whole bursts arrive back-to-back on one tick
        ticks_l: List[int] = []
        t = 0
        while len(ticks_l) < cfg.num_requests:
            n = min(cfg.burst_size, cfg.num_requests - len(ticks_l))
            ticks_l.extend([t] * n)
            t += max(1, int(rng.exponential(cfg.burst_gap_ticks)))
        ticks = np.asarray(ticks_l)
    entries = []
    for rid in range(cfg.num_requests):
        plen = int(rng.integers(cfg.prompt_len_lo, cfg.prompt_len_hi + 1))
        mnew = int(rng.integers(cfg.max_new_lo, cfg.max_new_hi + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        entries.append(TraceEntry(rid, int(ticks[rid]), prompt, mnew))
    return entries


@dataclasses.dataclass
class TrafficReport:
    """Replay outcome: completion, latency percentiles, concurrency and
    memory-pressure counters."""
    completed: int
    total: int
    unfinished: int
    ticks: int
    duration_s: float
    tokens_out: int
    tokens_per_s: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    latency_p50_ms: float
    latency_p99_ms: float
    queue_wait_p50_ms: float
    queue_wait_p99_ms: float
    max_inflight: int
    mean_inflight: float
    preemptions: int = 0
    kv_peak_utilization: float = 0.0
    kv_mean_utilization: float = 0.0
    kv_alloc_failures: int = 0

    def summary(self) -> str:
        return (
            f"{self.completed}/{self.total} done in {self.ticks} ticks "
            f"({self.duration_s * 1e3:.1f} ms): {self.tokens_per_s:.0f} tok/s, "
            f"ttft p50/p99 {self.ttft_p50_ms:.2f}/{self.ttft_p99_ms:.2f} ms, "
            f"latency p50/p99 {self.latency_p50_ms:.2f}/"
            f"{self.latency_p99_ms:.2f} ms, inflight max/mean "
            f"{self.max_inflight}/{self.mean_inflight:.1f}, "
            f"preempt {self.preemptions}, kv util peak/mean "
            f"{self.kv_peak_utilization:.2f}/{self.kv_mean_utilization:.2f}"
        )


def _pct(vals: List[float], q: float) -> float:
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals), q))


def run_trace(engine, trace: List[TraceEntry], max_ticks: int = 100_000,
              strict: bool = False) -> TrafficReport:
    """Replay ``trace`` against ``engine``: before each tick, admit every
    entry whose arrival tick has come (FIFO within a tick), then tick.
    Runs until all requests finish or ``max_ticks`` (strict=True raises on
    truncation)."""
    pending = sorted(trace, key=lambda e: (e.arrive_tick, e.rid))
    reqs: List[Request] = [
        Request(e.rid, e.prompt, max_new_tokens=e.max_new_tokens)
        for e in pending
    ]
    queue = list(zip(pending, reqs, strict=False))
    inflight_sum = 0
    max_inflight = 0
    t0 = time.perf_counter()
    tick = 0
    while tick < max_ticks:
        while queue and queue[0][0].arrive_tick <= tick:
            _, req = queue.pop(0)
            engine.admit(req)
        if not queue and not engine.busy:
            break
        engine.tick()
        cur = engine.inflight
        inflight_sum += cur
        max_inflight = max(max_inflight, cur)
        tick += 1
    duration = time.perf_counter() - t0
    unfinished = len(queue) + engine.unfinished_requests
    if unfinished and strict:
        raise RuntimeError(
            f"trace truncated at max_ticks={max_ticks}: {unfinished} of "
            f"{len(trace)} request(s) unfinished"
        )
    done = [r for r in reqs if r.done]
    tokens_out = sum(len(r.out_tokens or ()) for r in reqs)
    ttfts = [r.ttft_s * 1e3 for r in done if r.ttft_s is not None]
    lats = [r.latency_s * 1e3 for r in done if r.latency_s is not None]
    waits = [r.queue_wait_s * 1e3 for r in done if r.queue_wait_s is not None]
    st = engine.stats()
    kv = st.get("kv_blocks") or {}
    return TrafficReport(
        completed=len(done),
        total=len(reqs),
        unfinished=unfinished,
        ticks=tick,
        duration_s=duration,
        tokens_out=tokens_out,
        tokens_per_s=tokens_out / duration if duration > 0 else 0.0,
        ttft_p50_ms=_pct(ttfts, 50),
        ttft_p99_ms=_pct(ttfts, 99),
        latency_p50_ms=_pct(lats, 50),
        latency_p99_ms=_pct(lats, 99),
        queue_wait_p50_ms=_pct(waits, 50),
        queue_wait_p99_ms=_pct(waits, 99),
        max_inflight=max_inflight,
        mean_inflight=inflight_sum / max(1, tick),
        preemptions=int(st.get("preemptions", 0)),
        kv_peak_utilization=float(kv.get("peak_utilization", 0.0)),
        kv_mean_utilization=float(kv.get("mean_utilization", 0.0)),
        kv_alloc_failures=int(kv.get("alloc_failures", 0)),
    )
