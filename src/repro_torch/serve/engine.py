"""Batched serving engines: prefill + decode with KV/SSM caches and
continuous batching.  The reference's ``repro/serve/engine.py`` over
``repro_torch.models``: the same classes, counters and scheduling
decisions, tick for tick.

Two engines share the decode substrate:

* :class:`ServeEngine` — the contiguous **slot-ring** engine: a fixed pool
  of batch slots, each with a reserved ``max_len`` KV ring.  Prefill runs
  synchronously inside ``admit`` (in token chunks); every ``tick`` is one
  batched decode step.  Kept as the token-parity oracle — it is the
  simplest thing that is correct.

* :class:`PagedServeEngine` — the **paged continuous-batching** engine:
  KV lives in fixed-size blocks handed out by a free-list
  :class:`~repro_torch.serve.paged.BlockAllocator`; requests own block
  tables, not slots, so concurrency is bounded by *actual* context
  footprint instead of worst-case ``pool_size * max_len`` reservation.  A
  :class:`~repro_torch.serve.scheduler.Scheduler` admits and retires
  requests every step and interleaves batched prefill chunks with decode
  batches under a TTFT/latency SLO budget; block exhaustion preempts the
  latest-admitted request (freed blocks + front-of-queue requeue, resumed
  by recomputation — greedy decode makes the resumed token stream
  identical).

Greedy sampling happens INSIDE the step for both engines: each launch
returns a ``(width,)`` int32 token vector, not ``(width, vocab)`` logits —
the per-token device→host transfer on the decode hot path is a handful of
ints.

Where the reference ``jax.jit``s each step into one executable, an engine
on the card captures each of its steps (decode, and the prefill chunk) into
a CUDA graph on its first launch and replays it (``replay=None``, the
default; ``replay=False`` runs the step eagerly).  On the CPU the steps run
eagerly.  A graph reads the engine's own parameters, cache and static input
buffers at fixed addresses, so it belongs to one engine; what engines share
is the step function (``_DECODE_CACHE``).  Host state (slot positions,
block tables, token matrices) stays numpy, as in the reference: a launch
copies the step's inputs into its static buffers and the token vector back.

Admission validates prompts: empty prompts are rejected outright, and
prompts that would scatter past the KV capacity (``len(prompt) >
max_len - 1``) are rejected instead of silently corrupting the cache.
Each rejected request is counted once, however many times a retry loop
re-submits it.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import executor as _executor
from ..core.device import resolve_device
from ..models import decode_chunk, decode_step, init_cache, init_paged_cache
from ..models.module import tree_leaves
from .paged import BlockAllocator, blocks_for_tokens
from .scheduler import (
    DECODE_ACTION,
    PREFILL,
    PREFILL_ACTION,
    RUNNING,
    Scheduler,
    SLOConfig,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False
    # per-request latency/throughput accounting (perf_counter stamps)
    t_submit: Optional[float] = None   # first admit() attempt (queue entry)
    t_admit: Optional[float] = None    # slot claimed, prefill started
    t_first: Optional[float] = None    # first generated token (TTFT end)
    t_done: Optional[float] = None     # request finished

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from submission (includes queue wait)."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def tokens_per_s(self) -> Optional[float]:
        if not self.out_tokens or self.latency_s in (None, 0.0):
            return None
        return len(self.out_tokens) / self.latency_s


# Decode step functions are shared across engines with the same
# (config, pool[, chunk]) — the serving-layer analogue of the compiler's
# fusion-signature kernel dedup.  What is cached is the eager step (the
# reference's function before ``jax.jit``); each engine captures its own
# CUDA graph of it.  LRU-bounded: a long-lived server process cycling
# through configs/pool sizes must not grow this without limit.
_DECODE_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_DECODE_CACHE_CAP = 8
_DECODE_CACHE_EVICTIONS = 0


def _cached_jit(key: Tuple, build: Callable[[], Callable]) -> Tuple[Callable, bool]:
    global _DECODE_CACHE_EVICTIONS
    hit = key in _DECODE_CACHE
    if hit:
        _DECODE_CACHE.move_to_end(key)
    else:
        _DECODE_CACHE[key] = build()
        while len(_DECODE_CACHE) > _DECODE_CACHE_CAP:
            _DECODE_CACHE.popitem(last=False)   # evict least-recently-used
            _DECODE_CACHE_EVICTIONS += 1
    return _DECODE_CACHE[key], hit


def _greedy(logits, cfg):
    """Greedy sampling INSIDE the step: ships a (B,) int32 vector to the
    host instead of (B, padded_vocab) f32 logits every launch.  On ties
    ``torch.argmax`` returns the first index, as ``jnp.argmax`` does."""
    return torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)


def _decode_fn(cfg, pool_size: int) -> Tuple[Callable, bool]:
    def build():
        def fn(p, c, t, pos, act):
            logits, c2 = decode_step(p, c, t, pos, cfg, act)
            return _greedy(logits, cfg), c2

        return fn

    return _cached_jit(("step", repr(cfg), pool_size), build)


def _decode_chunk_fn(cfg, pool_size: int, chunk: int) -> Tuple[Callable, bool]:
    def build():
        def fn(p, c, t, pos, act, lens):
            logits, c2 = decode_chunk(p, c, t, pos, cfg, act, lens)
            return _greedy(logits, cfg), c2

        return fn

    return _cached_jit(("chunk", repr(cfg), pool_size, chunk), build)


def _paged_decode_fn(cfg, width: int, ring: int, block_size: int,
                     num_blocks: int) -> Tuple[Callable, bool]:
    def build():
        def fn(p, c, t, pos, act, bt):
            logits, c2 = decode_step(p, c, t, pos, cfg, act, bt, ring)
            return _greedy(logits, cfg), c2

        return fn

    return _cached_jit(
        ("paged_step", repr(cfg), width, ring, block_size, num_blocks), build
    )


def _paged_chunk_fn(cfg, width: int, chunk: int, ring: int, block_size: int,
                    num_blocks: int) -> Tuple[Callable, bool]:
    def build():
        def fn(p, c, t, pos, act, lens, bt):
            logits, c2 = decode_chunk(p, c, t, pos, cfg, act, lens, bt, ring)
            return _greedy(logits, cfg), c2

        return fn

    return _cached_jit(
        ("paged_chunk", repr(cfg), width, chunk, ring, block_size, num_blocks),
        build,
    )


def decode_cache_size() -> int:
    return len(_DECODE_CACHE)


def decode_cache_stats() -> Dict[str, int]:
    return {
        "size": len(_DECODE_CACHE),
        "cap": _DECODE_CACHE_CAP,
        "evictions": _DECODE_CACHE_EVICTIONS,
    }


# ======================================================================
# the engine's device and its steps
# ======================================================================
def _engine_device(params, device) -> torch.device:
    """The device an engine runs on (the card unless the caller asks for
    the CPU).  The parameters must already lie there: they are never moved."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stray = sorted({str(t.device) for t in tree_leaves(params) if t.device != dev})
    if stray:
        raise ValueError(
            f"the engine runs on {dev} but parameters lie on {stray}: put them "
            "there first (init_params(..., device=...)); the engine moves none"
        )
    return dev


def _replay_mode(dev: torch.device, replay: Optional[bool]) -> bool:
    """``replay=None``: the CUDA graph on the card, eager on the CPU;
    ``replay=True`` needs the card."""
    if replay is None:
        return dev.type == "cuda"
    if replay:
        _executor._need_card(dev)
    return bool(replay)


_Spec = Tuple[str, Tuple[int, ...], torch.dtype]


class _Step:
    """One model step of one engine — the reference's jitted call — run
    eagerly, or captured into a CUDA graph on its first launch and replayed.

    ``inputs`` names the step's arguments after the parameters and the
    cache, with their shapes and dtypes.  Each has a static buffer on the
    engine's device, the tensor the step (and its graph) reads.  A launch
    writes the host's numpy values into pinned host tensors (on the card),
    copies them into the static buffers, runs the step or replays its
    graph, and copies the (width,) int32 token vector back to the host
    once: the reference's ``np.asarray(out)``, which every latency stamp
    follows."""

    def __init__(self, kind: str, fn: Callable, params, cache,
                 inputs: Sequence[_Spec], device: torch.device, replay: bool):
        self.kind = kind
        self.fn = fn
        self.params, self.cache = params, cache
        self.device = device
        self.replay = replay
        self.names = [name for name, _, _ in inputs]
        self.static = [torch.zeros(shape, dtype=dt, device=device) for _, shape, dt in inputs]
        pinned = device.type == "cuda"
        self.host = [torch.zeros(shape, dtype=dt, pin_memory=True) if pinned else s
                     for (_, shape, dt), s in zip(inputs, self.static, strict=True)]
        self.graph = None
        self.static_out: Optional[torch.Tensor] = None
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.instantiate_s: Optional[float] = None

    def _run(self) -> List[torch.Tensor]:
        return [self.fn(self.params, self.cache, *self.static)[0]]

    def _capture(self) -> None:
        """Warm up on a side stream, then capture, both on a dry batch:
        every row inactive, so the warm-up writes only the parking slot or
        block and leaves each row's KV and recurrent state as it was.  A
        failed capture raises; there is no eager fallback."""
        self.static[self.names.index("active")].zero_()
        _executor._warm_up(self._run, self.device)
        t0 = time.perf_counter()
        self.graph, (self.static_out,) = _executor._capture_graph(
            self._run, self.device, keep_graph=True)
        t1 = time.perf_counter()
        self.graph.instantiate()
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1

    def __call__(self, *values: np.ndarray) -> np.ndarray:
        if self.replay and self.graph is None:
            self._capture()
        for host, static, value in zip(self.host, self.static, values, strict=True):
            host.numpy()[...] = value
            if host is not static:
                static.copy_(host, non_blocking=True)
        if self.replay:
            self.graph.replay()
            self.replays += 1
            out = self.static_out
        else:
            (out,) = self._run()
        return out.cpu().numpy()

    def stats(self) -> Dict[str, object]:
        return {"captured": self.graph is not None, "replays": self.replays,
                "capture_s": self.capture_s, "instantiate_s": self.instantiate_s}


def _graph_stats(steps: Sequence[_Step]) -> Dict[str, object]:
    """The engine's own keys beside the reference's: captures, replays, and
    each graph's capture and instantiation seconds."""
    return {
        "graph_captures": sum(s.graph is not None for s in steps),
        "graph_replays": sum(s.replays for s in steps),
        "graphs": {s.kind: s.stats() for s in steps},
    }


class _ValidationMixin:
    """Prompt validation + once-per-request rejection accounting, shared by
    both engines."""

    def _init_validation(self):
        self.requests_rejected = 0
        self._rejected_ids: set = set()
        self._rejected_refs: List[Request] = []   # pin ids against reuse

    def _count_rejection(self, req: Request) -> None:
        # retrying admit() with the same invalid request must not inflate
        # the counter: one rejected request == one rejection
        if id(req) not in self._rejected_ids:
            self._rejected_ids.add(id(req))
            self._rejected_refs.append(req)
            self.requests_rejected += 1

    def _validate(self, req: Request) -> None:
        n = len(req.prompt)
        if n == 0:
            self._count_rejection(req)
            raise ValueError(
                f"request {req.rid}: empty prompt — there is no position to "
                "decode from; send at least one (e.g. BOS) token"
            )
        if n > self.max_len - 1:
            self._count_rejection(req)
            raise ValueError(
                f"request {req.rid}: prompt length {n} exceeds the KV cache "
                f"(max_len={self.max_len}, limit {self.max_len - 1}) — it "
                "would silently wrap the ring and corrupt earlier positions"
            )


def _run_until_done(engine, max_ticks: int, strict: bool) -> int:
    t = 0
    while engine.busy and t < max_ticks:
        engine.tick()
        t += 1
    remaining = engine.unfinished_requests
    if remaining:
        msg = (
            f"run_until_done stopped at max_ticks={max_ticks} with "
            f"{remaining} request(s) still in flight or queued — the run "
            f"is TRUNCATED, not complete"
        )
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return remaining


def _zero_rows(cache, idx: int) -> None:
    """Zero row ``idx`` of the per-row recurrent (SSM/conv) state in place,
    where a captured graph reads it (the reference rebinds new arrays)."""
    for a in cache.get("mamba", {}).values():
        a[:, idx].zero_()


class ServeEngine(_ValidationMixin):
    """The contiguous slot-ring engine (token-parity oracle)."""

    def __init__(self, cfg, params, pool_size: int = 4, max_len: int = 512,
                 prefill_chunk: int = 16, device=None,
                 replay: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.device = _engine_device(params, device)
        self.replay = _replay_mode(self.device, replay)
        self.pool = pool_size
        self.max_len = max_len
        self.prefill_chunk = max(1, prefill_chunk)
        self.cache = init_cache(cfg, pool_size, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * pool_size
        self.slot_pos = np.zeros(pool_size, np.int32)
        self.slot_remaining = np.zeros(pool_size, np.int32)
        self.slot_last = np.zeros(pool_size, np.int32)
        self._decode, self.decode_cache_hit = _decode_fn(cfg, pool_size)
        row = [("pos", (pool_size,), torch.int32), ("active", (pool_size,), torch.bool)]
        self._steps = [_Step(
            "step", self._decode, params, self.cache,
            [("tokens", (pool_size,), torch.int32)] + row, self.device, self.replay)]
        self._decode_chunk = None
        if self.prefill_chunk > 1:
            self._decode_chunk, _ = _decode_chunk_fn(
                cfg, pool_size, self.prefill_chunk
            )
            self._steps.append(_Step(
                "chunk", self._decode_chunk, params, self.cache,
                [("tokens", (pool_size, self.prefill_chunk), torch.int32)] + row
                + [("lengths", (pool_size,), torch.int32)], self.device, self.replay))
        self.wait_queue: "deque[Request]" = deque()
        self.ticks = 0
        self.tokens_generated = 0
        self.requests_completed = 0
        self._init_validation()
        self.prefill_launches = 0        # decode calls spent on prefill
        self.prefill_tokens = 0          # prompt tokens prefilled
        self.decode_launches = 0         # batched tick decode calls

    @property
    def active_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is not None]

    @property
    def inflight(self) -> int:
        """Requests currently holding cache state (occupied slots)."""
        return sum(r is not None for r in self.slot_req)

    @property
    def busy(self) -> bool:
        return bool(self.wait_queue) or self.inflight > 0

    @property
    def unfinished_requests(self) -> int:
        return len(self.wait_queue) + self.inflight

    def stats(self) -> Dict[str, object]:
        """Serving counters: launch accounting + queue depth, then the
        CUDA graphs' captures and replays.

        ``prefill_launches`` vs ``prefill_tokens`` is the chunked-prefill
        win: the per-token loop would spend one launch per prompt token.
        """
        return {
            "ticks": self.ticks,
            "tokens_generated": self.tokens_generated,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "prefill_launches": self.prefill_launches,
            "prefill_tokens": self.prefill_tokens,
            "decode_launches": self.decode_launches,
            "prefill_chunk": self.prefill_chunk,
            "queue_depth": len(self.wait_queue),
            "decode_cache": decode_cache_stats(),
            **_graph_stats(self._steps),
        }

    # ------------------------------------------------------------ admit
    def admit(self, req: Request) -> bool:
        """Place ``req`` in a free slot (True) or park it on the FIFO wait
        queue (False — it is NOT dropped; ticks drain the queue as slots
        free up).  Invalid prompts raise ValueError and are never queued.
        """
        self._validate(req)
        # retry-loop callers (`while pending and admit(pending[0])`) may
        # re-admit a request that is already generating in a slot or
        # already finished — never place or queue those again, or a done
        # request would be re-prefilled and re-generated
        if req.done or any(r is req for r in self.slot_req):
            return False
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        # FIFO fairness + no double-placement: queued requests claim freed
        # slots before this one (draining also places req itself if it was
        # already at the front of the queue)
        self._drain_queue()
        if any(r is req for r in self.slot_req):
            return True
        for s in range(self.pool):
            if self.slot_req[s] is None:
                self._place(s, req)
                return True
        if not any(q is req for q in self.wait_queue):
            self.wait_queue.append(req)
        return False

    def _place(self, slot: int, req: Request) -> None:
        self.slot_req[slot] = req
        req.out_tokens = []
        req.t_admit = time.perf_counter()
        self._reset_slot_state(slot)
        self._prefill(slot, req)

    def _reset_slot_state(self, slot: int) -> None:
        """Zero the per-slot recurrent state before a new occupant.

        Attention KV needs no reset — the length mask hides stale rows —
        but SSM/conv state is UNMASKED recurrent carry: without this, a
        mamba/hybrid slot leaks the previous request's state into the next
        one (wrong tokens on every slot reuse)."""
        _zero_rows(self.cache, slot)

    def _drain_queue(self) -> None:
        while self.wait_queue:
            head = self.wait_queue[0]
            if head.done or any(r is head for r in self.slot_req):
                self.wait_queue.popleft()   # stale entry — never re-place
                continue
            free = next(
                (s for s, r in enumerate(self.slot_req) if r is None), None
            )
            if free is None:
                return
            self._place(free, self.wait_queue.popleft())

    # ---------------------------------------------------------- prefill
    def _prefill(self, slot: int, req: Request):
        toks = np.asarray(req.prompt).astype(np.int32)
        if self.prefill_chunk > 1:
            out_toks = self._prefill_chunked(slot, toks)
        else:
            out_toks = self._prefill_per_token(slot, toks)
        self.prefill_tokens += len(toks)
        self.slot_pos[slot] = len(toks)
        self.slot_remaining[slot] = req.max_new_tokens
        nxt = int(out_toks[slot])
        req.out_tokens.append(nxt)
        req.t_first = time.perf_counter()
        self.slot_last[slot] = nxt
        self.slot_remaining[slot] -= 1
        self.tokens_generated += 1
        # same stop rule as tick: out of budget, or the next decode write
        # would land past the KV ring
        if (
            self.slot_remaining[slot] <= 0
            or self.slot_pos[slot] >= self.max_len - 1
        ):
            self._finish(slot)

    def _prefill_chunked(self, slot: int, toks: np.ndarray):
        """One masked batched decode launch per ``prefill_chunk`` tokens."""
        C = self.prefill_chunk
        active = np.zeros(self.pool, bool)
        active[slot] = True
        out = None
        for start in range(0, len(toks), C):
            part = toks[start:start + C]
            tok_mat = np.zeros((self.pool, C), np.int32)
            tok_mat[slot, : len(part)] = part
            lengths = np.zeros(self.pool, np.int32)
            lengths[slot] = len(part)
            pos = self.slot_pos.copy()
            pos[slot] = start
            out = self._steps[1](tok_mat, pos, active, lengths)
            self.prefill_launches += 1
        return out

    def _prefill_per_token(self, slot: int, toks: np.ndarray):
        """The chunk-size-1 oracle: one decode launch per prompt token."""
        active = np.zeros(self.pool, bool)
        active[slot] = True
        out = None
        for i, t in enumerate(toks):
            tok_vec = np.zeros(self.pool, np.int32)
            tok_vec[slot] = t
            pos = self.slot_pos.copy()
            pos[slot] = i
            out = self._steps[0](tok_vec, pos, active)
            self.prefill_launches += 1
        return out

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.t_done = time.perf_counter()
        self.slot_req[slot] = None
        self.requests_completed += 1

    # ------------------------------------------------------------- tick
    def tick(self) -> None:
        """Drain the wait queue into free slots, then one batched decode
        step for all active slots (per-slot pos)."""
        self._drain_queue()
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return
        toks = self.slot_last.copy()
        arr = self._steps[0](toks, self.slot_pos, active)
        self.decode_launches += 1
        for s in np.nonzero(active)[0]:
            r = self.slot_req[s]
            nxt = int(arr[s])
            r.out_tokens.append(nxt)
            self.slot_last[s] = nxt
            self.slot_pos[s] += 1
            self.slot_remaining[s] -= 1
            self.tokens_generated += 1
            if self.slot_remaining[s] <= 0 or self.slot_pos[s] >= self.max_len - 1:
                self._finish(s)
        self.ticks += 1

    def run_until_done(self, max_ticks: int = 2000, strict: bool = False) -> int:
        """Tick until idle or ``max_ticks``.  Returns the number of
        requests still unfinished (0 == complete); a truncated run warns,
        or raises RuntimeError with ``strict=True`` — harnesses must not
        mistake a truncated run for a completed one."""
        return _run_until_done(self, max_ticks, strict)


# ======================================================================
# paged continuous batching
# ======================================================================
@dataclasses.dataclass
class _Row:
    """One decode-batch row of the paged engine (NOT a KV reservation —
    KV lives in blocks owned by the request's block table)."""
    req: Optional[Request] = None
    state: str = ""
    ctx: Optional[np.ndarray] = None   # tokens to feed: prompt [+ resumed out]
    fed: int = 0                       # prefill progress into ctx
    pos: int = 0                       # next absolute write position
    blocks: List[int] = dataclasses.field(default_factory=list)
    last_tok: int = 0
    remaining: int = 0
    admit_seq: int = -1


class PagedServeEngine(_ValidationMixin):
    """Continuous batching over paged KV memory.

    ``decode_width`` is the batched-launch width (how many requests decode
    per tick); KV memory is ``num_blocks * block_size`` tokens TOTAL,
    shared by every in-flight request through per-request block tables.
    With the same KV budget as a slot engine (``pool * max_len`` tokens),
    short-context traffic sustains many times ``pool`` in-flight requests.
    """

    def __init__(self, cfg, params, decode_width: int = 16,
                 max_len: int = 512, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 16,
                 slo: Optional[SLOConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None, replay: Optional[bool] = None):
        if decode_width <= 0:
            raise ValueError(f"decode_width must be positive, got {decode_width}")
        self.cfg = cfg
        self.params = params
        self.device = _engine_device(params, device)
        self.replay = _replay_mode(self.device, replay)
        self.width = decode_width
        self.max_len = max_len
        self.prefill_chunk = max(1, prefill_chunk)
        self._clock = clock
        # logical ring capacity in tokens (sliding-window archs reuse
        # blocks cyclically past the window) — same formula as init_cache
        self.kv_ring = (
            max_len if not cfg.sliding_window
            else min(cfg.sliding_window, max_len)
        )
        self.needs_kv = cfg.family != "ssm"
        self.block_size = block_size
        self.blocks_per_req = (
            blocks_for_tokens(self.kv_ring, block_size, self.kv_ring)
            if self.needs_kv else 0
        )
        if not self.needs_kv:
            num_blocks = 0
        elif num_blocks is None:
            # no-pressure default: worst case for every row
            num_blocks = decode_width * self.blocks_per_req
        if self.needs_kv and num_blocks < self.blocks_per_req:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold even one max-length "
                f"context ({self.blocks_per_req} blocks of {block_size}) — "
                "a lone request could deadlock"
            )
        self.num_blocks = num_blocks
        self.allocator = (
            BlockAllocator(num_blocks, block_size) if self.needs_kv else None
        )
        self.cache = init_paged_cache(cfg, num_blocks, block_size, decode_width,
                                      device=self.device)
        # logical->physical tables, parking-filled (physical id num_blocks)
        self._parking = num_blocks
        self._table = np.full(
            (decode_width, max(1, self.blocks_per_req)), self._parking,
            np.int32,
        )
        self.rows = [_Row() for _ in range(decode_width)]
        self.sched = Scheduler(slo, clock)
        self._decode, self.decode_cache_hit = _paged_decode_fn(
            cfg, decode_width, self.kv_ring, block_size, num_blocks
        )
        self._chunk, _ = _paged_chunk_fn(
            cfg, decode_width, self.prefill_chunk, self.kv_ring, block_size,
            num_blocks,
        )
        W = decode_width
        row = [("pos", (W,), torch.int32), ("active", (W,), torch.bool)]
        table = [("table", self._table.shape, torch.int32)]
        self._steps = [
            _Step("step", self._decode, params, self.cache,
                  [("tokens", (W,), torch.int32)] + row + table, self.device, self.replay),
            _Step("chunk", self._chunk, params, self.cache,
                  [("tokens", (W, self.prefill_chunk), torch.int32)] + row
                  + [("lengths", (W,), torch.int32)] + table, self.device, self.replay),
        ]
        self._admit_seq = 0
        self.ticks = 0
        self.tokens_generated = 0
        self.requests_completed = 0
        self._init_validation()
        self.prefill_launches = 0
        self.prefill_tokens = 0
        self.decode_launches = 0
        self.max_inflight = 0
        self._inflight_ticks = 0
        self._util_ticks = 0.0

    # ------------------------------------------------------- properties
    @property
    def inflight(self) -> int:
        """Requests currently holding rows/blocks (prefilling or running)."""
        return sum(r.req is not None for r in self.rows)

    @property
    def busy(self) -> bool:
        return bool(self.sched.waiting) or self.inflight > 0

    @property
    def unfinished_requests(self) -> int:
        return len(self.sched.waiting) + self.inflight

    @property
    def wait_queue(self):
        """Launcher compatibility: the scheduler's FIFO wait queue."""
        return self.sched.waiting

    def stats(self) -> Dict[str, object]:
        st: Dict[str, object] = {
            "ticks": self.ticks,
            "tokens_generated": self.tokens_generated,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "prefill_launches": self.prefill_launches,
            "prefill_tokens": self.prefill_tokens,
            "decode_launches": self.decode_launches,
            "prefill_chunk": self.prefill_chunk,
            "decode_width": self.width,
            "queue_depth": len(self.sched.waiting),
            "inflight": self.inflight,
            "max_inflight": self.max_inflight,
            "mean_inflight": self._inflight_ticks / max(1, self.ticks),
            "preemptions": self.sched.preemptions,
            "scheduler": self.sched.stats(),
            "decode_cache": decode_cache_stats(),
            **_graph_stats(self._steps),
        }
        if self.allocator is not None:
            kv = self.allocator.stats()
            kv["mean_utilization"] = self._util_ticks / max(1, self.ticks)
            st["kv_blocks"] = kv
        return st

    # ------------------------------------------------------------ admit
    def admit(self, req: Request) -> bool:
        """Asynchronous admission: True == the request owns a decode row
        and will prefill over the next ticks; False == parked on the FIFO
        wait queue (never dropped).  No model launch happens here — prefill
        is the scheduler's job, interleaved with decode under the SLO."""
        self._validate(req)
        if req.done or any(r.req is req for r in self.rows):
            return False
        if req.t_submit is None:
            req.t_submit = self._clock()
        self._admit_from_queue()
        if any(r.req is req for r in self.rows):
            return True
        # FIFO: nobody overtakes a still-backed-up queue
        if not self.sched.waiting and self._try_place(req):
            return True
        if not any(q is req for q in self.sched.waiting):
            self.sched.enqueue(req)
        return False

    def _admit_from_queue(self) -> None:
        while self.sched.waiting:
            head = self.sched.waiting[0]
            if head.done or any(r.req is head for r in self.rows):
                self.sched.waiting.popleft()   # stale entry
                continue
            if not self._try_place(head):
                return                         # head-of-line blocks: FIFO
            self.sched.waiting.popleft()

    def _try_place(self, req: Request) -> bool:
        free_row = next(
            (i for i, r in enumerate(self.rows) if r.req is None), None
        )
        if free_row is None:
            return False
        ctx_len = len(req.prompt) + len(req.out_tokens or ())
        if self.allocator is not None:
            needed = blocks_for_tokens(ctx_len, self.block_size, self.kv_ring)
            # admission gate: the whole context must fit in FREE blocks now,
            # or prefill would immediately preempt someone (churn)
            if not self.allocator.can_alloc(needed):
                return False
        self._place_row(free_row, req)
        return True

    def _place_row(self, idx: int, req: Request) -> None:
        row = self.rows[idx]
        if req.out_tokens is None:
            req.out_tokens = []
        if req.t_admit is None:
            req.t_admit = self._clock()
        # resumed-after-preemption requests re-feed prompt + everything
        # already emitted (recompute preemption): greedy decode makes the
        # continuation token-identical to the uninterrupted run
        row.req = req
        row.state = PREFILL
        row.ctx = np.concatenate(
            [np.asarray(req.prompt, np.int32).ravel(),
             np.asarray(req.out_tokens, np.int32)]
        ).astype(np.int32)
        row.fed = 0
        row.pos = 0
        row.blocks = []
        row.last_tok = 0
        row.remaining = req.max_new_tokens - len(req.out_tokens)
        row.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.sched.admitted += 1
        self._table[idx, :] = self._parking
        self._reset_row_state(idx)

    def _reset_row_state(self, idx: int) -> None:
        """Zero per-row recurrent (SSM/conv) state for a new occupant —
        the unmasked carry would otherwise leak across requests."""
        _zero_rows(self.cache, idx)

    # ------------------------------------------------------ block paging
    def _ensure_blocks(self, idx: int, tokens_upto: int) -> None:
        """Grow ``idx``'s block table to cover ``tokens_upto`` context
        tokens, preempting the latest-admitted other request on exhaustion
        (eager-release + recompute, vLLM-style)."""
        if self.allocator is None:
            return
        row = self.rows[idx]
        needed = blocks_for_tokens(tokens_upto, self.block_size, self.kv_ring)
        while len(row.blocks) < needed:
            got = self.allocator.alloc(needed - len(row.blocks))
            if got is None:
                if not self._preempt_latest(exclude=idx):
                    raise RuntimeError(
                        "KV block pool exhausted with nothing left to "
                        "preempt — num_blocks < blocks_per_req?"
                    )
                continue
            start = len(row.blocks)
            row.blocks.extend(got)
            self._table[idx, start:start + len(got)] = got

    def _preempt_latest(self, exclude: int) -> bool:
        victims = [
            (self.rows[i].admit_seq, i)
            for i, r in enumerate(self.rows)
            if r.req is not None and i != exclude
        ]
        if not victims:
            return False
        _, idx = max(victims)
        self._preempt(idx)
        return True

    def _preempt(self, idx: int) -> None:
        row = self.rows[idx]
        req = row.req
        if self.allocator is not None and row.blocks:
            self.allocator.free(row.blocks)
        self._clear_row(idx)
        # front of the queue: FIFO by submission survives preemption
        self.sched.requeue_front(req)

    def _clear_row(self, idx: int) -> None:
        self.rows[idx] = _Row()
        self._table[idx, :] = self._parking

    # ------------------------------------------------------------- tick
    def tick(self) -> None:
        """One scheduler step: retire/admit, then ONE batched launch —
        a prefill chunk for every prefilling row, or a decode step for
        every running row — picked under the SLO budget."""
        self._admit_from_queue()
        prefill_rows = [
            i for i, r in enumerate(self.rows)
            if r.req is not None and r.state == PREFILL
        ]
        running_rows = [
            i for i, r in enumerate(self.rows)
            if r.req is not None and r.state == RUNNING
        ]
        oldest_wait = None
        chunks_rem = 0
        if prefill_rows:
            oldest = min(prefill_rows, key=lambda i: self.rows[i].admit_seq)
            r = self.rows[oldest]
            now = self._clock()
            oldest_wait = now - (r.req.t_submit if r.req.t_submit is not None
                                 else now)
            chunks_rem = -(-(len(r.ctx) - r.fed) // self.prefill_chunk)
        action = self.sched.choose(
            len(prefill_rows), len(running_rows), oldest_wait, chunks_rem
        )
        if action == PREFILL_ACTION:
            self._prefill_launch(prefill_rows)
        elif action == DECODE_ACTION:
            self._decode_launch(running_rows)
        self.ticks += 1
        infl = self.inflight
        self.max_inflight = max(self.max_inflight, infl)
        self._inflight_ticks += infl
        if self.allocator is not None:
            self._util_ticks += self.allocator.utilization

    # ---------------------------------------------------------- prefill
    def _prefill_launch(self, prefill_rows: List[int]) -> None:
        """ONE masked ``decode_chunk`` launch advancing EVERY prefilling
        row by up to ``prefill_chunk`` of its own prompt tokens (per-row
        pos + ragged lengths) — batched prefill across requests, not just
        within one."""
        C = self.prefill_chunk
        for i in list(prefill_rows):
            row = self.rows[i]
            if row.req is None or row.state != PREFILL:
                continue    # preempted by an earlier row's allocation
            part_len = min(C, len(row.ctx) - row.fed)
            self._ensure_blocks(i, row.fed + part_len)
        launched = [
            i for i in prefill_rows
            if self.rows[i].req is not None and self.rows[i].state == PREFILL
        ]
        if not launched:
            return
        tok_mat = np.zeros((self.width, C), np.int32)
        lens = np.zeros(self.width, np.int32)
        posv = np.zeros(self.width, np.int32)
        act = np.zeros(self.width, bool)
        for i in launched:
            row = self.rows[i]
            part = row.ctx[row.fed:row.fed + C]
            tok_mat[i, : len(part)] = part
            lens[i] = len(part)
            posv[i] = row.fed
            act[i] = True
        t0 = self._clock()
        toks = self._steps[1](tok_mat, posv, act, lens, self._table)
        self.sched.observe_launch(PREFILL_ACTION, self._clock() - t0)
        self.prefill_launches += 1
        for i in launched:
            row = self.rows[i]
            row.fed += int(lens[i])
            self.prefill_tokens += int(lens[i])
            if row.fed >= len(row.ctx):
                # prefill complete: the chunk's last-valid-position logits
                # already produced this row's next token inside the step
                row.pos = row.fed
                row.state = RUNNING
                if row.req.t_first is None:
                    row.req.t_first = self._clock()
                self._append_token(i, int(toks[i]))

    # ----------------------------------------------------------- decode
    def _decode_launch(self, running_rows: List[int]) -> None:
        for i in list(running_rows):
            row = self.rows[i]
            if row.req is None or row.state != RUNNING:
                continue
            self._ensure_blocks(i, row.pos + 1)
        launched = [
            i for i in running_rows
            if self.rows[i].req is not None and self.rows[i].state == RUNNING
        ]
        if not launched:
            return
        toks = np.zeros(self.width, np.int32)
        posv = np.zeros(self.width, np.int32)
        act = np.zeros(self.width, bool)
        for i in launched:
            row = self.rows[i]
            toks[i] = row.last_tok
            posv[i] = row.pos
            act[i] = True
        t0 = self._clock()
        arr = self._steps[0](toks, posv, act, self._table)
        self.sched.observe_launch(DECODE_ACTION, self._clock() - t0)
        self.decode_launches += 1
        for i in launched:
            self.rows[i].pos += 1
            self._append_token(i, int(arr[i]))

    def _append_token(self, idx: int, tok: int) -> None:
        row = self.rows[idx]
        req = row.req
        req.out_tokens.append(tok)
        row.last_tok = tok
        row.remaining -= 1
        self.tokens_generated += 1
        # same stop rule as the slot engine: budget exhausted, or the next
        # write would land past the context capacity
        if row.remaining <= 0 or row.pos >= self.max_len - 1:
            self._finish_row(idx)

    def _finish_row(self, idx: int) -> None:
        row = self.rows[idx]
        req = row.req
        req.done = True
        req.t_done = self._clock()
        self.requests_completed += 1
        if self.allocator is not None and row.blocks:
            self.allocator.free(row.blocks)   # eager release, like the
            # executor's last-use buffer-slot frees
        self._clear_row(idx)

    def run_until_done(self, max_ticks: int = 5000, strict: bool = False) -> int:
        """Tick until idle or ``max_ticks``.  Returns the number of
        requests still unfinished (0 == complete); a truncated run warns,
        or raises RuntimeError with ``strict=True``."""
        return _run_until_done(self, max_ticks, strict)
