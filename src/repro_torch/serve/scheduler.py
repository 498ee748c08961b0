"""Continuous-batching scheduler: admission, prefill/decode interleaving
under an SLO budget, and preemption policy.  The reference's
``repro/serve/scheduler.py``, copied (pure Python, injectable clock).

Every engine tick the scheduler (a) drains the FIFO wait queue into free
decode rows for which enough KV blocks exist, and (b) picks ONE launch:
a batched prefill chunk (advances every prefilling row by up to
``prefill_chunk`` prompt tokens in a single masked ``decode_chunk`` call)
or a batched decode step (one token for every running row).  Prefill is no
longer synchronous inside ``admit`` — a long prompt can no longer stall
every in-flight decode for its whole length.

Arbitration between the two is the TTFT-vs-latency tradeoff:

  * ``decode_slo_s`` — if the gap since the last decode launch exceeds it,
    decode wins (running requests' inter-token latency is protected);
  * ``ttft_slo_s`` — if the oldest prefilling request's projected finish
    (measured wait + EMA-estimated remaining chunk time) would overrun
    ``safety * ttft_slo_s``, prefill wins;
  * neither at risk (or both SLOs None, the default): strict alternation,
    which is deterministic in ticks — what the traffic benchmark gates on.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

# request lifecycle states (engine-side rows carry these)
WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
DONE = "done"

PREFILL_ACTION = "prefill"
DECODE_ACTION = "decode"
IDLE_ACTION = "idle"


@dataclasses.dataclass
class SLOConfig:
    """Latency targets steering the prefill/decode interleave.

    ``None`` disables an SLO term; with both None the scheduler strictly
    alternates prefill and decode launches (tick-deterministic)."""
    ttft_slo_s: Optional[float] = None    # submit -> first token target
    decode_slo_s: Optional[float] = None  # max gap between decode launches
    safety: float = 0.8                   # act at safety * ttft_slo_s

    def __post_init__(self):
        for name in ("ttft_slo_s", "decode_slo_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive or None, got {v}")
        if not (0 < self.safety <= 1):
            raise ValueError(f"safety must be in (0, 1], got {self.safety}")


class Scheduler:
    """Policy state for one engine: wait queue + interleave arbitration.

    The engine owns device state (cache, rows, block tables); the
    scheduler owns the queue and the prefill-vs-decode decision so policy
    is testable with a fake clock and no model at all."""

    def __init__(self, slo: Optional[SLOConfig] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.slo = slo or SLOConfig()
        self.clock = clock
        self.waiting: "deque" = deque()
        self.last_action = DECODE_ACTION   # so the first contested pick prefills
        self.last_decode_t: Optional[float] = None
        self.ema_prefill_s: Optional[float] = None
        self.ema_decode_s: Optional[float] = None
        self.admitted = 0
        self.preemptions = 0
        self.prefill_launches_chosen = 0
        self.decode_launches_chosen = 0
        self.ttft_overrides = 0            # SLO forced prefill over decode
        self.decode_overrides = 0          # SLO forced decode over prefill

    # ------------------------------------------------------------ queue
    def enqueue(self, req) -> None:
        self.waiting.append(req)

    def requeue_front(self, req) -> None:
        """Preempted requests rejoin at the FRONT: they were admitted (and
        therefore submitted) before anything still waiting — FIFO order by
        submission survives preemption."""
        self.waiting.appendleft(req)
        self.preemptions += 1

    # ----------------------------------------------------- measurements
    def observe_launch(self, action: str, seconds: float) -> None:
        """EMA of per-launch wall time, feeding the TTFT projection."""
        attr = "ema_prefill_s" if action == PREFILL_ACTION else "ema_decode_s"
        prev = getattr(self, attr)
        setattr(self, attr, seconds if prev is None
                else 0.7 * prev + 0.3 * seconds)

    # ------------------------------------------------------ arbitration
    def choose(self, n_prefill: int, n_running: int,
               oldest_prefill_wait_s: Optional[float] = None,
               chunks_remaining: int = 0) -> str:
        """Pick this tick's launch. ``oldest_prefill_wait_s`` is
        now - t_submit for the oldest request still prefilling;
        ``chunks_remaining`` its remaining prefill chunks."""
        if n_prefill == 0 and n_running == 0:
            return IDLE_ACTION
        if n_prefill == 0:
            action = DECODE_ACTION
        elif n_running == 0:
            action = PREFILL_ACTION
        else:
            action = None
            now = self.clock()
            if (
                self.slo.decode_slo_s is not None
                and self.last_decode_t is not None
                and now - self.last_decode_t > self.slo.decode_slo_s
            ):
                action = DECODE_ACTION
                self.decode_overrides += 1
            elif (
                self.slo.ttft_slo_s is not None
                and oldest_prefill_wait_s is not None
            ):
                projected = oldest_prefill_wait_s + chunks_remaining * (
                    self.ema_prefill_s or 0.0
                )
                if projected > self.slo.safety * self.slo.ttft_slo_s:
                    action = PREFILL_ACTION
                    self.ttft_overrides += 1
            if action is None:   # neither SLO at risk: strict alternation
                action = (
                    PREFILL_ACTION
                    if self.last_action == DECODE_ACTION
                    else DECODE_ACTION
                )
        if action == DECODE_ACTION:
            self.last_decode_t = self.clock()
            self.decode_launches_chosen += 1
        else:
            self.prefill_launches_chosen += 1
        self.last_action = action
        return action

    def stats(self) -> dict:
        return {
            "queue_depth": len(self.waiting),
            "admitted": self.admitted,
            "preemptions": self.preemptions,
            "prefill_launches_chosen": self.prefill_launches_chosen,
            "decode_launches_chosen": self.decode_launches_chosen,
            "ttft_overrides": self.ttft_overrides,
            "decode_overrides": self.decode_overrides,
        }
