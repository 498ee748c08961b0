"""Loss, train-step builders (with microbatch gradient accumulation) and the
fault-tolerant training driver: the reference's ``repro/train/trainer.py``
in torch.

``make_train_step`` returns the reference's ``(params, opt_state, batch)
-> (params, opt_state, metrics)`` step, gradients by ``torch.autograd``.
It updates ``params`` and ``opt_state`` in place and returns them, as
``jax.jit(step, donate_argnums=(0, 1))`` hands the caller new buffers in the
donated ones' place.  ``CapturedTrainStep`` runs such a step on the card
captured once into a CUDA graph and replays it.  The driver (``Trainer``)
adds checkpointing and auto-resume, the straggler watchdog and failure
injection.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import executor as _executor
from ..core.device import resolve_device
from ..models import forward
from ..models import layers as L
from ..models.module import tree_leaves, tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, adamw_update_

F32 = torch.float32

#: the params' subtrees stacked over layers (``_scan_layers`` walks them)
_STACKED = ("layers", "enc_layers")


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """logits (..., Vp) f32; labels (...) int (-1 = ignore).  Returns
    (sum nll, count).  Vocab padding columns are masked out."""
    Vp = logits.shape[-1]
    col = torch.arange(Vp, device=logits.device)
    logits = torch.where(col < vocab_size, logits, -1e30)
    m = torch.amax(logits, dim=-1, keepdim=True)
    z = logits - m
    lse = torch.log(torch.sum(torch.exp(z), dim=-1)) + m[..., 0]
    lbl = torch.clamp(labels, 0, Vp - 1).long()
    picked = torch.gather(logits, -1, lbl[..., None])[..., 0]
    nll = lse - picked
    mask = (labels >= 0).to(F32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    total, denom = cross_entropy_sums(logits, labels, vocab_size)
    return total / torch.clamp(denom, min=1.0)


def _chunk_len(S: int, target: int) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def make_loss_sums_fn(cfg):
    """(params, batch) -> (sum nll, count of valid labels): the chunked CE
    of ``make_loss_fn`` before its division, which a sharded step divides
    by the count over every rank's rows."""
    from torch.utils.checkpoint import checkpoint

    def chunk_sums(embed, hc, lc):
        logits = L.unembed(embed, hc).to(F32)
        return cross_entropy_sums(logits, lc, cfg.vocab_size)

    def sums_fn(params, batch):
        hidden = forward(params, batch, cfg, return_hidden=True)   # (B, S, d)
        labels = torch.as_tensor(batch["labels"], device=hidden.device)
        B, S, d = hidden.shape
        c = _chunk_len(S, cfg.loss_chunk)
        nc = S // c
        if nc <= 1:
            logits = L.unembed(params["embed"], hidden).to(F32)
            return cross_entropy_sums(logits, labels, cfg.vocab_size)
        tot = torch.zeros((), dtype=F32, device=hidden.device)
        cnt = torch.zeros((), dtype=F32, device=hidden.device)
        for i in range(nc):
            hc, lc = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
            if torch.is_grad_enabled():
                t, n = checkpoint(chunk_sums, params["embed"], hc, lc, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                t, n = chunk_sums(params["embed"], hc, lc)
            tot, cnt = tot + t, cnt + n
        return tot, cnt

    return sums_fn


def make_loss_fn(cfg):
    """Chunked CE: the (B, S, Vp) logits tensor is never materialized — the
    unembed product and the CE run per sequence chunk.

    Autograd would keep every chunk's f32 logits (and their exponentials)
    alive until the backward pass, as the reference's scan would without
    remat, so each chunk runs under ``torch.utils.checkpoint``: only its
    (B, c, d) hidden slice is kept, and its logits are made again in the
    backward pass.  That changes no value; the peak is one chunk's
    logits."""
    sums_fn = make_loss_sums_fn(cfg)

    def loss_fn(params, batch):
        tot, cnt = sums_fn(params, batch)
        return tot / torch.clamp(cnt, min=1.0)

    return loss_fn


def _grad_leaves(params):
    """The params as autograd leaves: the tree ``forward`` reads and the
    leaves' list.  A stacked subtree becomes a list of one tree a layer
    (views of the stack), so each layer's gradient comes alone; the layers
    come layer-major, each layer's leaves in tree order."""
    leaves: List[torch.Tensor] = []

    def leaf(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    tree = {}
    for k, sub in params.items():
        if k in _STACKED:
            n = next(tree_leaves(sub)).shape[0]
            tree[k] = [tree_map(lambda t, i=i: leaf(t[i]), sub) for i in range(n)]
        else:
            tree[k] = tree_map(leaf, sub)
    return tree, leaves


def _grads_like(params, grads: List[Optional[torch.Tensor]]):
    """The gradients in ``_grad_leaves``' order as a tree like ``params``,
    each stacked leaf's layers stacked again; a layer's gradient is dropped
    once stacked, so the peak is one stacked leaf above the gradients."""
    out, pos = {}, 0
    for k, sub in params.items():
        n_leaf = sum(1 for _ in tree_leaves(sub))
        if k in _STACKED:
            depth = next(tree_leaves(sub)).shape[0]
            stacked = []
            for j in range(n_leaf):
                idx = [pos + i * n_leaf + j for i in range(depth)]
                stacked.append(torch.stack([grads[x] for x in idx]))
                for x in idx:
                    grads[x] = None
            pos += depth * n_leaf
        else:
            stacked = grads[pos:pos + n_leaf]
            pos += n_leaf
        it = iter(stacked)
        out[k] = tree_map(lambda t: next(it), sub)
    return out


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn)(params, batch)`` by ``torch.autograd``:
    (the loss, detached; gradients in a tree like ``params``, zeros for a
    leaf the loss does not reach)."""
    with torch.enable_grad():
        tree, leaves = _grad_leaves(params)
        loss = loss_fn(tree, batch)
        grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
    return loss.detach(), _grads_like(params, grads)


def _device_batch(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    accum_steps: int = 1,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), params
    and state updated in place (the module docstring).  ``batch`` holds
    numpy arrays or tensors; the step runs on the params' device.

    With ``accum_steps > 1`` the batch is split on its leading axis and the
    gradients accumulate in f32, microbatch after microbatch, as the
    reference's ``lax.scan`` does."""
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state: AdamWState, batch):
        dev = params["embed"]["tok"].device
        batch = _device_batch(batch, dev)
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=dev), params)
            loss = torch.zeros((), dtype=F32, device=dev)
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])[i]
                      for k, v in batch.items()}
                lval, g = value_and_grad(loss_fn, params, mb)
                tree_map(lambda a, b: a.add_(b.to(F32)), grads, g)
                loss = loss + lval
                del g
            tree_map(lambda g: g.div_(accum_steps), grads)
            loss = loss / accum_steps
        params, opt_state, om = adamw_update_(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


class CapturedTrainStep:
    """A train step on the card, captured once into a CUDA graph and
    replayed: the port's stand-in for ``jax.jit(step, donate_argnums=(0,
    1))``.

    The graph holds the whole step (forward, backward, clipping, the LR
    schedule, the AdamW update).  It reads the batch from static buffers
    and writes the params, the optimizer state and the metrics in place,
    so it belongs to the params and state it was captured with: a call with
    other tensors raises.  Each call copies the batch's numpy values
    through pinned host tensors into the static buffers and replays;
    nothing in the step syncs with the host.

    The first call is the warm-up that a capture asks for: it runs the
    step eagerly on a side stream (a real step, whose result it returns),
    frees what the warm-up cached, then captures the step into a graph of
    its own memory pool (a capture runs nothing) and instantiates it.
    Later calls replay.  ``capture_s`` and ``instantiate_s`` time those."""

    def __init__(self, step_fn: Callable, device=None):
        self.step_fn = step_fn
        self.device = _executor._need_card(resolve_device(device))
        self.graph = None
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.instantiate_s: Optional[float] = None
        self._bound: Optional[List[int]] = None
        self._copied = None

    @staticmethod
    def _addresses(params, opt_state) -> List[int]:
        return [t.data_ptr() for t in (*tree_leaves(params), opt_state.step,
                                        *tree_leaves(opt_state.m), *tree_leaves(opt_state.v))]

    def _load(self, batch) -> None:
        """The batch into the static buffers, through the pinned host
        tensors on the card; a host tensor is written only once the last
        call's copy out of it is done."""
        if self._copied is not None:
            self._copied.synchronize()
        for k, v in batch.items():
            host = self.host[k]
            if isinstance(v, torch.Tensor):
                host.copy_(v)
            else:
                host.numpy()[...] = v
            if host is not self.static[k]:
                self.static[k].copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _run(self) -> None:
        _, _, metrics = self.step_fn(self.params, self.opt_state, self.static)
        for k, t in metrics.items():
            self.static_metrics[k].copy_(t)

    def _capture(self, params, opt_state, batch):
        self.params, self.opt_state = params, opt_state
        self._bound = self._addresses(params, opt_state)
        pinned = self.device.type == "cuda"
        self.static = {k: torch.empty(tuple(np.shape(v)), dtype=torch.as_tensor(v).dtype,
                                      device=self.device) for k, v in batch.items()}
        self.host = {k: torch.empty(s.shape, dtype=s.dtype, pin_memory=True) if pinned else s
                     for k, s in self.static.items()}
        self._load(batch)
        first = []
        _executor._warm_up(
            lambda: first.append(self.step_fn(params, opt_state, self.static)[2]), self.device)
        metrics = first[0]
        self.static_metrics = {k: t.detach().clone() for k, t in metrics.items()}
        if pinned:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.graph, _ = _executor._capture_graph(self._run, self.device, keep_graph=True)
        t1 = time.perf_counter()
        self.graph.instantiate()
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
        return params, opt_state, metrics

    def __call__(self, params, opt_state: AdamWState, batch):
        if self.graph is None:
            return self._capture(params, opt_state, batch)
        if self._addresses(params, opt_state) != self._bound:
            raise ValueError(
                "a captured train step writes the params and optimizer state it was "
                "captured with; pass those (the trees each call returns)")
        self._load(batch)
        self.graph.replay()
        self.replays += 1
        return params, opt_state, {k: t.clone() for k, t in self.static_metrics.items()}

    def stats(self) -> Dict[str, object]:
        return {"captured": self.graph is not None, "replays": self.replays,
                "capture_s": self.capture_s, "instantiate_s": self.instantiate_s}


def make_stitched_train_step(
    loss_fn: Callable,
    opt_cfg: AdamWConfig,
    options=None,
    **stitch_kwargs,
):
    """Compile ``grad_and_value(loss_fn)`` + the AdamW update as ONE stitched
    plan, over ``repro_torch.stitch``: forward, backward, gradient
    clipping, LR schedule and the per-leaf elementwise update towers are
    captured and planned together.  ``params`` and ``opt_state`` are
    donated (``donate_argnums=(0, 1)``), as in the reference.

    The caller rebinds its state to the outputs, as with ``jax.jit``: the
    eager loop may write a donated input's buffer with a later kernel's
    output, and a replayed call reads its own copies of the feeds and
    returns fresh tensors; in both the outputs are the new state.

    ``loss_fn(params, batch) -> scalar`` must be stitchable (no gather);
    MLP/MSE-style losses are.  Returns a ``StitchedFunction`` with the
    ``make_train_step`` signature."""
    from ..frontend import stitch

    def train_step(params, opt_state: AdamWState, batch):
        grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    stitch_kwargs.setdefault("name", "train_step")
    stitch_kwargs.setdefault("donate_argnums", (0, 1))
    return stitch(train_step, options=options, **stitch_kwargs)


# ======================================================================
# fault-tolerant driver
# ======================================================================
@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    straggler_threshold: float = 3.0     # x median step time


class StragglerWatchdog:
    """EMA step-time monitor; flags steps slower than k x the running
    median.  On a real fleet the flag triggers backup-task dispatch; here it
    feeds the trainer's metrics and the fault-tolerance tests."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.times: list = []
        self.window = window
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        import statistics

        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
                return True
        return False


class FailureInjector:
    """Deterministic failure injection for restart tests."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


class Trainer:
    """The reference's driver.  Its default step is ``make_train_step``,
    captured once into a CUDA graph on the card (``CapturedTrainStep``)
    and run eagerly on ``device="cpu"``.  ``float(metrics["loss"])`` is
    read after each step, outside the graph."""

    def __init__(
        self,
        cfg,
        opt_cfg: AdamWConfig,
        tcfg: TrainerConfig,
        data_iter_factory: Callable[[int], Any],
        checkpoint_manager=None,
        train_step: Optional[Callable] = None,
        failure_injector: Optional[FailureInjector] = None,
        device=None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_iter_factory = data_iter_factory
        self.ckpt = checkpoint_manager
        self.device = resolve_device(device)
        if train_step is None:
            train_step = make_train_step(cfg, opt_cfg)
            if self.device.type == "cuda":
                train_step = CapturedTrainStep(train_step, self.device)
        self.train_step = train_step
        self.watchdog = StragglerWatchdog(tcfg.straggler_threshold)
        self.injector = failure_injector
        self.history: list = []

    def run(self, params, opt_state=None, start_step: int = 0):
        opt_state = opt_state if opt_state is not None else adamw_init(params)
        step = start_step
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(params, opt_state)
            if restored is not None:
                params, opt_state, step = restored
        data = self.data_iter_factory(step)
        while step < self.tcfg.total_steps:
            if self.injector is not None:
                self.injector.maybe_fail(step)
            batch = next(data)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self.watchdog.observe(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt, "straggler": slow})
            step += 1
            if self.ckpt is not None and step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, params, opt_state)
        if self.ckpt is not None:
            self.ckpt.save(step, params, opt_state)
        return params, opt_state, step
