"""Measured-cost autotuning of the port — ``repro/core/measure.py``.

The cost planner trusts ``core/latency.py``'s analytic model, whose
constants are the reference's TPU's.  This module fits the plans to the
device the port runs on the way the reference fits them to its own: time
each compiled kernel on that device and remember the result.

  * ``measure_callable`` / ``measure_kernel`` time a compiled kernel with
    warm-up and the median of ``repeats`` runs.  On the card each run is a
    CUDA graph of ``GRAPH_BATCH`` launches between two ``torch.cuda.Event``s
    (the kernel's device time); on the CPU,
    where the kernel runs its plain version, by ``time.perf_counter``, so
    the CPU tests exercise the whole loop (those timings describe the plain
    version on the host, and the device fingerprint keeps them apart).
  * ``emit_group`` compiles an arbitrary member set as one kernel through
    the tune -> memory-plan -> codegen path (single-schedule when one
    exists, multi-phase stitched otherwise), built and loaded on the card,
    so a harness can time alternatives the planner did not commit.
  * ``MeasuredCostStore`` persists results as versioned JSON rows (the
    port's copy of the reference's store protocol, over ``JsonStore``),
    keyed by a device fingerprint and the fusion's measure key.  Rows of
    another schema, another device or a corrupt payload are evicted on
    read (counted, never raised), so a device swap degrades to a cold
    retune.

The planner side is the reference's: ``FusionScorer`` prefers a measured
cost where a key hits (``core/fusion.py``), ``SchedulePass`` applies store
hits and ``AutotunePass`` measures the misses (``core/pipeline.py``).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import cuda_build
from .codegen import StitchedKernel, assemble_source, emit_fusion, emit_stitched_fusion
from .device import resolve_device
from .fusion import FusedComputation
from .ir import Instruction, torch_dtype
from .latency import H100, TPU_V5E, DeviceSpec, LatencyModel
from .memory import MemoryInfeasible, plan_memory, plan_stitched_memory
from .perf_library import JsonStore, PerfLibrary
from .schedule import resolve_stitched
from .tuning import tune

# Version of the on-disk row schema; rows of any other version are evicted.
MEASURE_SCHEMA_VERSION = 1


def device_fingerprint(spec: DeviceSpec = TPU_V5E, device=None) -> str:
    """Fingerprint of the measurement substrate: the ``DeviceSpec``
    constants, the device type (``"cuda"`` or ``"cpu"``) and, on the card,
    ``torch.cuda.get_device_name``.  A CPU timing never serves a card
    compile, and one card's timing never serves another card.  ``device``
    is the card unless the caller asks for the CPU (``resolve_device``)."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    feats = (spec.fingerprint(), dev.type, name, "repro_torch")
    return hashlib.sha256(repr(feats).encode()).hexdigest()[:16]


@dataclass(frozen=True)
class MeasuredCost:
    """One remembered measurement: seconds for a fusion on a device, with
    the analytic prediction recorded when it was measured."""

    cost_s: float
    model_s: float
    repeats: int


class MeasuredCostStore:
    """Versioned persistent map: (device fingerprint, measure key) ->
    measured kernel seconds.  ``get`` validates every row (schema version,
    device field, payload) and evicts rather than raises, so the planner
    falls back to the analytic model and plan feasibility never changes.
    ``device_fp`` is required: the compile that makes the store knows its
    device (``device_fingerprint``)."""

    def __init__(self, path: Optional[str] = None, device_fp: Optional[str] = None):
        if not device_fp:
            raise ValueError("a MeasuredCostStore needs the device fingerprint it serves")
        self._disk = JsonStore(path)
        self.device_fp = device_fp
        self.hits = 0
        self.misses = 0
        self.stale_discards = 0
        self.measurements_taken = 0

    @property
    def path(self) -> Optional[str]:
        return self._disk.path

    def key(self, signature: str) -> str:
        return f"{self.device_fp}|{signature}"

    def get(self, signature: str) -> Optional[MeasuredCost]:
        rec = self._disk.get(self.key(signature))
        if rec is None:
            self.misses += 1
            return None
        try:
            if rec.get("version") != MEASURE_SCHEMA_VERSION:
                raise ValueError(f"schema version {rec.get('version')!r}")
            if rec.get("device") != self.device_fp:
                raise ValueError(f"device {rec.get('device')!r}")
            cost = MeasuredCost(
                cost_s=float(rec["cost_s"]),
                model_s=float(rec.get("model_s", 0.0)),
                repeats=int(rec.get("repeats", 1)),
            )
            if not (cost.cost_s > 0.0) or not np.isfinite(cost.cost_s):
                raise ValueError(f"cost_s {rec['cost_s']!r}")
        except (ValueError, TypeError, KeyError, AttributeError):
            self._disk.pop(self.key(signature))
            self.stale_discards += 1
            self.misses += 1
            return None
        self.hits += 1
        return cost

    def put(self, signature: str, cost_s: float, model_s: float = 0.0, repeats: int = 1) -> None:
        self.measurements_taken += 1
        self._disk.put(self.key(signature), {
            "version": MEASURE_SCHEMA_VERSION,
            "device": self.device_fp,
            "cost_s": float(cost_s),
            "model_s": float(model_s),
            "repeats": int(repeats),
        })

    def save(self) -> None:
        self._disk.save()

    def __len__(self) -> int:
        return len(self._disk)

    def __contains__(self, signature: str) -> bool:
        return self.key(signature) in self._disk


# --------------------------------------------------------------------------
# The timing harness
# --------------------------------------------------------------------------


#: calls of a kernel one timed CUDA graph replays back to back
GRAPH_BATCH = 20


def measure_callable(fn, args: Sequence, device=None, repeats: int = 5, warmup: int = 1) -> float:
    """Median seconds of ``fn(*args)`` over ``repeats`` runs after
    ``warmup`` untimed ones.  On the card ``fn`` is captured ``GRAPH_BATCH``
    times into a CUDA graph and each run is one replay between two CUDA
    events, divided by ``GRAPH_BATCH``: the device time of a call, which is
    what the analytic model predicts, not the host's time to launch it
    (tens of µs through the Python wrapper, against 1-10 µs on the card).
    On the CPU it is wall time.  ``device`` is the card unless the caller
    asks for the CPU."""
    dev = resolve_device(device)
    repeats = max(1, int(repeats))
    for _ in range(max(0, int(warmup))):
        fn(*args)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_BATCH):
                fn(*args)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / GRAPH_BATCH)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _random_args(inputs: List[Instruction], rng, device) -> List[torch.Tensor]:
    """Random tensors of a kernel's input shapes and dtypes, made on the
    device before the clock starts.  No StitchIR kernel has data-dependent
    control flow, so uniform noise times them as any data would."""
    args = []
    for i in inputs:
        dt = np.dtype(i.dtype)
        if dt == np.bool_:
            a = rng.rand(*i.shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            hi = max(2, i.shape[0] if i.shape else 2)
            a = rng.randint(0, hi, size=i.shape)
        else:   # floats, bf16 included: values in [-1, 1) cast on the way in
            a = rng.uniform(-1, 1, size=i.shape).astype(np.float32)
        args.append(torch.as_tensor(a).to(device=device, dtype=torch_dtype(i.dtype)))
    return args


def measure_kernel(kernel: StitchedKernel, device=None, repeats: int = 5, warmup: int = 1,
                   seed: int = 0) -> float:
    """Time one compiled kernel on random inputs (median of ``repeats``),
    on the card unless the caller asks for the CPU.  A measurement leaves
    the kernel's launch counter as it found it: the counter counts the
    launches of the plan's calls, and a timing's launches, made at compile
    time, are none of them."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    args = _random_args(kernel.inputs, rng, device)
    before = kernel.fn.launches
    try:
        return measure_callable(lambda *a: kernel(*a, device=device), args, device,
                                repeats=repeats, warmup=warmup)
    finally:
        kernel.fn.launches = before


# --------------------------------------------------------------------------
# Candidate lowerings: compile an arbitrary member set through the real path
# --------------------------------------------------------------------------


def emit_group(
    members: List[Instruction],
    library: Optional[PerfLibrary] = None,
    *,
    vmem_limit: Optional[int] = None,
    replicate_limit: int = 512 * 1024,
    max_blocks: int = 4096,
    stitch_replicate_limit: Optional[int] = None,
    stitch_max_blocks: int = 64,
    device=None,
) -> Optional[StitchedKernel]:
    """Compile ``members`` as ONE kernel through the production path (§4.3
    tuning, §5.1 memory planning, §5.2 emission), falling back to the
    multi-phase stitched lowering where no single schedule exists; on the
    card (the default; ``device="cpu"`` asks for the plain version) the
    kernel is built and loaded.  None where the group has no feasible
    lowering under the limits (the sets the scorer refuses).  It plans for
    ``library``'s spec, by default the device's (``H100`` on the card,
    ``TPU_V5E`` on the CPU), within ``vmem_limit``, by default the spec's
    (``pipeline.default_vmem_limit``)."""
    from .pipeline import (  # pipeline imports this module
        default_stitch_replicate_limit,
        default_vmem_limit,
    )

    device = resolve_device(device)
    lib = library or PerfLibrary(model=LatencyModel(H100 if device.type == "cuda" else TPU_V5E))
    spec = lib.model.spec
    if vmem_limit is None:
        vmem_limit = default_vmem_limit(spec)
    fusion = FusedComputation(list(members), name="measured")
    roots = fusion.roots
    kernel = None
    tuned = tune(members, roots, lib, max_blocks=max_blocks, replicate_limit=replicate_limit,
                 vmem_limit=vmem_limit)
    if tuned is not None:
        try:
            mem = plan_memory(members, roots, tuned.solution, vmem_limit, spec)
        except MemoryInfeasible:
            return None
        kernel = emit_fusion(fusion, tuned.solution, mem)
    else:
        srl = (default_stitch_replicate_limit(spec, vmem_limit)
               if stitch_replicate_limit is None else stitch_replicate_limit)
        st = resolve_stitched(
            members, roots, replicate_limit=replicate_limit, max_blocks=max_blocks,
            stitch_replicate_limit=srl, stitch_max_blocks=stitch_max_blocks, spec=spec,
        )
        if st is None:
            return None
        try:
            mem = plan_stitched_memory(st, vmem_limit, spec)
        except MemoryInfeasible:
            return None
        kernel = emit_stitched_fusion(fusion, st, mem)
    if device.type == "cuda":
        lib_so, _ = cuda_build.load(assemble_source([kernel.fn]))
        kernel.fn.load(lib_so)
    return kernel


def measure_group(
    members: List[Instruction],
    library: Optional[PerfLibrary] = None,
    repeats: int = 5,
    seed: int = 0,
    device=None,
    **emit_kwargs,
) -> Optional[float]:
    """Median measured seconds of ``members`` lowered as one kernel, or
    None where the group has no feasible lowering under the limits; on the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    kernel = emit_group(members, library, device=device, **emit_kwargs)
    if kernel is None:
        return None
    return measure_kernel(kernel, device, repeats=repeats, seed=seed)
