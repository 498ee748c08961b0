"""The unified analytic latency model — ONE place for device constants and
roofline math.

``DeviceSpec`` is the single source of hardware constants
(``core/perf_library.py`` re-exports it as ``TpuSpec``) and
``LatencyModel`` is the one scoring object shared by the fusion planner
and the schedule tuner (through ``PerfLibrary.model``).  Two specs:
``TPU_V5E``, the reference's constants, and ``H100``, the card's, from its
data sheet and from ``chip_smoke.py``'s measurements.  A compile for the
card plans with ``H100``, a compile for the CPU with ``TPU_V5E`` (so the
port's CPU plans stay the reference's), and ``StitchOptions.device_spec``
overrides either (``core/compiler.py``); ``launch/roofline.py`` derives
its peaks from ``H100``.

What the model charges (see README "LatencyModel conventions"):
  * one ``launch_overhead_s`` per kernel plus ``grid_step_overhead_s`` per
    wave of the grid (``sm_count`` programs a wave; on the TPU's one core
    every grid program is a wave);
  * compute at roofline peak — MXU peak for dots (bf16 vs f32 by dtype),
    VPU-weighted flops for elementwise (``_EW_WEIGHT``) — derated by a
    lane-efficiency penalty when the chunk underfills the (8,128) tile;
  * HBM traffic for kernel inputs and root outputs; a replicated operand
    in a multi-block kernel is re-read per block (on a GPU only where it
    outgrows the L2, ``l2_bytes``);
  * VMEM traffic for buffered interior values (reduce / fusable-dot
    results — the same set ``memory.plan_memory`` marks required);
  * replication duplication: a replicated member of a multi-block kernel
    recomputes in every block;
  * on a GPU (``sm_count > 1``), the share of the card a kernel's grid
    fills: its HBM time at the bandwidth a grid of that many CUDA blocks
    reaches (``block_curve``, measured), its compute and shared-memory
    time at ``grid / sm_count`` of the peaks; a member the memory plan
    shrank to INLINE once for every read of it, a staged dot's operand
    once per tile it is staged for, at the measured rate of that op
    composed into a staged dot (``recompute_s``, ``staged_op_rates``);
    and a row-split dot's rhs, which every block reads whole, at the L2's
    measured rate (``l2_read_bytes``, ``l2_bw``).

Who decides what: this module prices a plan; the launch it prices on a GPU
(grid, threads, slots, each dot's loop) is ``core/geometry.py``'s
``PhaseLaunch``, the record the emitter (``core/codegen.py``) writes into
the kernel's text.  ``fusion_time`` and ``stitched_fusion_time`` share one
body a phase (``_phase_time``).  Imports run downward only: ``geometry``,
``schedule`` and ``ir``, never the emitter or the pipeline.

What it approximates:
  * perfect overlap of compute and HBM DMA inside one kernel
    (``max(compute, memory)``, not the sum);
  * non-buffered interior elementwise values are free on the TPU (thread
    composition re-computes them in registers);
  * no cross-block caching on the TPU, whose one TensorCore runs the grid
    in sequence.

A spec field that is NaN was not measured: a score that reads it raises
``NotMeasured`` naming the field, never compares a NaN.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import numpy as np

from .geometry import SMEM_LIMIT, PhaseLaunch, fusion_launch, stitched_launch
from .ir import Instruction
from .schedule import (
    REPLICATED,
    Sched,
    ScheduleSolution,
    StitchedSolution,
    blocks_of,
    chunk_shape,
    is_row_split_dot,
)


@dataclass(frozen=True)
class DeviceSpec:
    """Per-chip numbers; the defaults are TPU v5e's (``TPU_V5E``).

    ``core/perf_library.py`` re-exports this as ``TpuSpec``;
    ``launch/roofline.py`` derives its module constants from ``H100``.
    """

    peak_flops_bf16: float = 197e12
    peak_flops_f32: float = 98.5e12          # MXU fp32 ~ half bf16
    vpu_flops: float = 3.9e12                # 8x128x8 VPU lanes @ ~0.94 GHz x2
    hbm_bw: float = 819e9
    vmem_bw: float = 3.3e12                  # on-chip scratch, ~4x HBM
    vmem_bytes: int = 16 * 1024 * 1024
    ici_bw: float = 50e9                     # per link
    ici_latency_s: float = 1.0e-6            # per-collective hop/sync latency
    launch_overhead_s: float = 2.0e-6        # kernel dispatch
    grid_step_overhead_s: float = 1.0e-7     # per grid program (pipelined)
    phase_loop_overhead_s: float = 5.0e-7    # per stitched-phase transition
    sublane: int = 8
    lane: int = 128
    # What a GPU adds; the defaults are the TPU's one TensorCore, which runs
    # the grid's programs one after another at the whole chip's rates.
    sm_count: int = 1                        # grid programs that run at once
    # (CUDA blocks, fraction of hbm_bw a grid of that many blocks reaches),
    # measured; empty: min(1, blocks / sm_count)
    block_curve: Tuple[Tuple[int, float], ...] = ()
    l2_bytes: int = 0                        # cache re-reads hit; 0: none
    threads_per_sm: int = 0                  # resident threads an SM holds; 0: one program
    l2_bw: float = 0.0                       # the L2's read rate, bytes/s; 0: no L2
    # the largest whole rhs a row-split dot was measured to read at l2_bw,
    # bytes: the most a row split may replicate (``schedule.resolve_schedules``)
    l2_read_limit: int = 0
    # (op, elements a second) the card computes an op at where it is composed
    # into a staged dot's operand (``codegen.staged_dot_loop``), measured;
    # an op not listed is priced at vpu_flops over its weight
    staged_op_rates: Tuple[Tuple[str, float], ...] = ()

    @property
    def is_gpu(self) -> bool:
        """More than one grid program runs at once: the planner charges a
        grid by the share of the card it fills, and a slot lives in one
        block's shared memory (``memory.plan_memory``)."""
        return self.sm_count > 1

    def fingerprint(self) -> str:
        """Content hash of the hardware constants.  A measured kernel time is
        only meaningful relative to the device it was taken on, so the
        measured-cost tuning store (``core/measure.py``) keys every record by
        this fingerprint (combined with the runtime backend): a store carried
        to a different device spec degrades to all-misses — the analytic
        model — instead of replaying another chip's timings.  A field a GPU
        adds enters the hash only where it is not at its default, so
        ``TPU_V5E`` hashes as the reference's spec does."""
        feats = tuple(
            (f.name, getattr(self, f.name)) for f in fields(self)
            if f.name not in _GPU_FIELDS or getattr(self, f.name) != f.default
        )
        return hashlib.sha256(repr(feats).encode()).hexdigest()[:16]


_GPU_FIELDS = ("sm_count", "block_curve", "l2_bytes", "threads_per_sm", "l2_bw",
               "l2_read_limit", "staged_op_rates")


TPU_V5E = DeviceSpec()

_NOT_MEASURED = float("nan")

#: NVIDIA H100 SXM5 80 GB.  Peaks and rates from the data sheet; the
#: overheads, the shared-memory rate and the block-count curve measured by
#: ``chip_smoke.py`` phase 17 (c) with the port's own generated kernels.  A
#: field the card has no number for is NaN: a score that reads it raises.
H100 = DeviceSpec(
    peak_flops_bf16=989e12,          # dense bf16 on the tensor cores
    peak_flops_f32=67e12,            # f32 without the tensor cores (TF32 off)
    vpu_flops=67e12,                 # elementwise f32 on the CUDA cores
    hbm_bw=3.35e12,                  # HBM3
    # chip_smoke.py phase 17 (c) on an H100 (700 W): generated kernels over
    # (8448, 64) f32 in 264 plan blocks keeping 1 .. 8 chained slots, 2.285
    # .. 5.974 device µs; each step moves 6,488,064 bytes through shared
    # memory (a slot read, a slot written, a reduce's read, with two
    # barriers) in 0.5308 µs, the least-squares slope
    vmem_bw=12.22e12,
    vmem_bytes=SMEM_LIMIT,           # shared memory a block
    ici_bw=900e9,                    # NVLink 4, both directions summed (450 GB/s each way)
    ici_latency_s=_NOT_MEASURED,     # one card: no collective between cards measured
    # chip_smoke.py phase 17 (c) on an H100 (700 W): the generated exp
    # kernel's device time over (8, 256) f32 in one plan block, 1.150 µs;
    # over (8448, 256) f32 in 8 plan blocks against 1, (6.398 - 5.887) / 7 µs
    launch_overhead_s=1.15e-6,
    grid_step_overhead_s=7.3e-8,
    # phase 17 (c), the same card: a stitched kernel of an elementwise chain
    # over (528, 128) f32 cut into 1 .. 8 phases, 1.403 .. 13.954 device µs:
    # the least-squares slope, one grid barrier and one staged interface
    phase_loop_overhead_s=1.786e-6,
    # the (sublane, lane) tile is the TPU's vector register; a GPU has no
    # such tile: a warp of 32 threads is the nearest unit
    sublane=1,
    lane=32,
    sm_count=132,                    # multi_processor_count, phase 17 (c)
    # phase 17 (c), the same card: the fraction of hbm_bw the generated
    # x * rsqrt(mean(x * x)) kernel over (8448, 256) f32 reaches in 1 .. 264
    # plan blocks, one CUDA block of 512 threads each (1050.15 .. 5.94 µs)
    block_curve=((1, 0.00492), (2, 0.00954), (4, 0.01904), (8, 0.03770), (16, 0.07483),
                 (32, 0.13824), (64, 0.37575), (128, 0.72692), (132, 0.69094),
                 (256, 0.77300), (264, 0.86975)),
    l2_bytes=50 * 1024 * 1024,       # L2 cache (data sheet)
    # phase 17 (c), the same card: a row-split dot of (1, 2048, 512) by
    # (1, 512, 64) f32, one row a plan block, every block staging the whole
    # 131,072-byte rhs: 268,435,456 bytes from the L2 in 44.96 device µs.
    # The same dot of 24, 96 and 384 batches of 512 rows (whole rhs 3, 12
    # and 48 MiB, blocks dealt in batch order) read 6.43 .. 6.71e12 bytes/s:
    # the limit is the largest of them
    l2_bw=5.970e12,
    l2_read_limit=384 * 512 * 64 * 4,
    # phase 17 (c): a staged dot of (8, 512, 512) by (8, 512, 256) f32 whose
    # lhs composes 8 applications of the op, against the same dot on a
    # stored lhs (41.42 device µs): 16,777,216 elements over the added time.
    # A multiply's added time stayed within the run's noise: it falls back
    # to vpu_flops
    staged_op_rates=(("div", 1.416e12), ("exp", 2.791e12)),
    threads_per_sm=2048,             # resident threads an SM holds (data sheet)
)


class NotMeasured(ValueError):
    """A score read a ``DeviceSpec`` field that holds NaN (not measured)."""


class _Rates:
    """The spec's fields as attributes; a NaN field raises ``NotMeasured``
    naming it when a score reads it."""

    def __init__(self, spec: "DeviceSpec", name: str):
        self._name = name
        self._missing = set()
        for f in fields(spec):
            v = getattr(spec, f.name)
            if isinstance(v, float) and math.isnan(v):
                self._missing.add(f.name)
            else:
                setattr(self, f.name, v)

    def __getattr__(self, field: str):
        if field in self.__dict__.get("_missing", ()):
            raise NotMeasured(
                f"DeviceSpec {self._name}.{field} is NaN (not measured on this device); "
                "no score may read it"
            )
        raise AttributeError(field)


# VPU op weight: how many vector-op equivalents one element costs.
_EW_WEIGHT = {"add": 1, "sub": 1, "mul": 1, "max": 1, "min": 1, "neg": 1,
              "abs": 1, "sign": 1, "floor": 1, "not": 1, "and": 1, "or": 1,
              "lt": 1, "le": 1, "gt": 1, "ge": 1, "eq": 1, "ne": 1,
              "square": 1, "reciprocal": 4, "div": 4, "sqrt": 4, "rsqrt": 4,
              "exp": 8, "log": 8, "log1p": 8, "tanh": 12, "sigmoid": 10, "softplus": 12,
              "silu": 12, "gelu": 14, "pow": 16}

# Computationally trivial ops: inlined via thread composition during both
# schedule scoring (tuning.py) and planner scoring — charging them would
# veto good schedules (paper §4.3 optimization).
TRIVIAL_OPCODES = frozenset({"reshape", "bitcast", "broadcast", "constant", "iota", "slice"})
_SMALL_TRANSPOSE_ELEMS = 4096


def is_trivial(instr: Instruction) -> bool:
    if instr.opcode in TRIVIAL_OPCODES:
        return True
    if instr.opcode == "transpose" and instr.num_elements <= _SMALL_TRANSPOSE_ELEMS:
        return True
    return False


def instr_flops(instr: Instruction) -> float:
    """Model FLOPs of one instruction (elementwise weighted for the VPU)."""
    op = instr.opcode
    if op == "elementwise":
        w = _EW_WEIGHT.get(instr.attrs.get("fn"), 1)
        return instr.num_elements * w
    if op == "select":
        return instr.num_elements
    if op in ("reduce", "cumsum"):
        return instr.operands[0].num_elements
    if op == "dot":
        lhs = instr.operands[0]
        k = lhs.shape[-1]
        return 2.0 * instr.num_elements * k
    return 0.0  # shape modulation / data movement only


def instr_hbm_bytes(instr: Instruction) -> float:
    """HBM traffic of one instruction run standalone: read every operand
    once, write the output once."""
    return float(instr.bytesize) + sum(float(o.bytesize) for o in instr.operands)


def _lane_efficiency(chunk: Tuple[int, ...], spec: DeviceSpec) -> float:
    """Penalty for chunks that underfill the (8,128) VPU tile — the TPU
    analogue of the paper's warp-multiple thread-block constraint."""
    if not chunk:
        return 1.0
    lane = chunk[-1]
    sub = chunk[-2] if len(chunk) >= 2 else 1
    eff_l = min(1.0, lane / spec.lane) if lane < spec.lane else 1.0
    eff_s = min(1.0, sub / spec.sublane) if sub < spec.sublane else 1.0
    return max(0.05, eff_l * eff_s)


#: bytes one L1/L2 transaction moves on a GPU (a sector)
SECTOR_BYTES = 32


def rhs_read_across_lanes(dot: Instruction, member_ids, memory=None) -> bool:
    """Whether the generated dot loop reads its rhs with a stride across the
    lanes of a warp.  The lanes take neighbouring output columns, so a rhs
    composed (INLINE) from a transpose that moves its minor dim reads a
    whole sector for each element; a slot (shared memory) or a kernel input
    is read along its rows."""
    stack, seen = [dot.operands[1]], set()
    while stack:
        x = stack.pop()
        if x.id in seen or x.id not in member_ids:
            continue
        seen.add(x.id)
        if memory is not None and memory.action(x) != "INLINE":
            continue
        if x.opcode == "transpose":
            perm = tuple(x.attrs["perm"])
            if perm[-1] != len(perm) - 1:
                return True
            stack.extend(x.operands)
        elif x.opcode in ("elementwise", "select", "reshape", "bitcast", "broadcast"):
            stack.extend(x.operands)
    return False


def _spec_name(spec: DeviceSpec) -> str:
    if spec == TPU_V5E:
        return "TPU_V5E"
    if spec == H100:
        return "H100"
    return "DeviceSpec"


def _dot_reads(dot: Instruction, operand: Instruction, tiling=None, sched=None) -> int:
    """How many times the generated dot loop reads each element of one of
    its operands.  The register-tile loop (``tiling`` None): a thread keeps
    a 4 x 4 register tile of outputs, so an lhs element is read once for
    every 4 output columns, an rhs element once for every 4 output rows.
    The staged loop (a ``geometry.DotTiling`` under ``sched``): an lhs
    element once per column tile (BN columns), an rhs element once per row
    tile (BM rows), whichever plan block holds those rows."""
    lhs, rhs = dot.operands[0], dot.operands[1]
    rows = int(lhs.shape[-2] if len(lhs.shape) >= 2 else 1)
    reads = 0
    if tiling is not None:
        cols = chunk_shape(dot.shape, sched)[-1]
        if operand.id == lhs.id:
            reads += cols // tiling.bn
        if operand.id == rhs.id:
            reads += rows // tiling.bm
        return max(1, reads)
    if operand.id == lhs.id:
        reads += -(-int(rhs.shape[-1]) // 4)
    if operand.id == rhs.id:
        reads += -(-rows // 4)
    return max(1, reads)


def _recompute_reads(members: Sequence[Instruction], memory, tilings=None, assignment=None):
    """(shrunk member, its reads past the first): a member the memory plan
    shrank to INLINE (``MemoryPlan.shrunk``) is composed into every read of
    it, so it runs once for each read past the first — once per reader
    element, and for a dot reader as ``_dot_reads`` counts (``tilings``:
    each dot's ``geometry.DotTiling`` or None, under ``assignment``)."""
    if memory is None or not memory.shrunk:
        return []
    shrunk = set(memory.shrunk)
    member_ids = {m.id for m in members}
    out = []
    for m in members:
        if m.name not in shrunk:
            continue
        reads = 0.0
        for u in m.users:
            if u.id not in member_ids:
                continue
            if u.opcode == "dot":
                t = (tilings or {}).get(u.id)
                reads += _dot_reads(u, m, t, assignment[u.id] if t is not None else None)
            else:
                reads += max(1.0, u.num_elements / max(1, m.num_elements))
        out.append((m, max(0.0, reads - 1.0)))
    return out


def recompute_flops(members: Sequence[Instruction], memory, tilings=None, assignment=None) -> float:
    """Flops a kernel spends recomputing the members its memory plan shrank
    to INLINE (``_recompute_reads``)."""
    return sum(extra * instr_flops(m)
               for m, extra in _recompute_reads(members, memory, tilings, assignment))


class LatencyModel:
    """Device spec + per-op / per-fusion / per-module time estimates.

    One instance is shared across the whole compile: the fusion planner
    scores candidate partitions, ``PerfLibrary`` uses ``op_time`` as its
    miss handler, ``tuning.score`` finishes with ``kernel_time`` (on a GPU
    the tuner scores each schedule with ``fusion_time``), and
    ``launch/roofline.py`` builds its table from the ``*_time`` roofline
    terms — all against the same ``DeviceSpec``.  Scores read the spec
    through ``rates``, which raises ``NotMeasured`` for a NaN field.
    """

    def __init__(self, spec: DeviceSpec = TPU_V5E):
        self.spec = spec
        self.rates = _Rates(spec, _spec_name(spec))

    # ---- the share of the card a grid fills (1 on the TPU) ---------------
    def hbm_share(self, grid: int) -> float:
        """Fraction of ``hbm_bw`` a grid of ``grid`` CUDA blocks reaches: the
        measured ``block_curve``, linear in log2(blocks) between its points
        and flat past its ends; without a curve, ``min(1, grid / sm_count)``."""
        r = self.rates
        if r.sm_count <= 1:
            return 1.0
        g = max(1, int(grid))
        curve = r.block_curve
        if not curve:
            return min(1.0, g / r.sm_count)
        if g <= curve[0][0]:
            return curve[0][1]
        for (b0, f0), (b1, f1) in zip(curve, curve[1:]):
            if g <= b1:
                w = (math.log2(g) - math.log2(b0)) / (math.log2(b1) - math.log2(b0))
                return f0 + w * (f1 - f0)
        return curve[-1][1]

    def compute_share(self, grid: int) -> float:
        """Fraction of the compute and shared-memory peaks a grid of
        ``grid`` blocks reaches: one block an SM at most."""
        r = self.rates
        if r.sm_count <= 1:
            return 1.0
        return min(1.0, max(1, int(grid)) / r.sm_count)

    def waves(self, grid: int, threads: int = 0) -> int:
        """Grid steps charged for ``grid`` programs: every program on the
        TPU's one core; on a GPU one for each wave of the blocks of
        ``threads`` threads that the SMs hold at once."""
        r = self.rates
        if r.sm_count <= 1:
            return grid
        per_sm = max(1, r.threads_per_sm // threads) if threads and r.threads_per_sm else 1
        return -(-max(1, int(grid)) // (r.sm_count * per_sm))

    @property
    def prices_collectives(self) -> bool:
        """Whether the spec holds the link numbers a collective is charged by."""
        return not any(math.isnan(getattr(self.spec, f)) for f in ("ici_bw", "ici_latency_s"))

    def composed_rate(self, m: Instruction) -> float:
        """Elements a second the card computes ``m`` at where it is
        composed into a staged dot's operand: the measured
        ``staged_op_rates``, else ``vpu_flops`` over its flops an element."""
        r = self.rates
        fn = m.attrs.get("fn") if m.opcode == "elementwise" else None
        rate = dict(r.staged_op_rates).get(fn)
        if rate:
            return rate
        per = instr_flops(m) / max(1, m.num_elements)
        return r.vpu_flops / per if per else math.inf

    def recompute_s(self, members, memory, tilings=None, assignment=None) -> float:
        """Seconds a GPU kernel spends recomputing its shrunk members
        (``_recompute_reads``), each at ``composed_rate``."""
        return sum(extra * m.num_elements / self.composed_rate(m)
                   for m, extra in _recompute_reads(members, memory, tilings, assignment))

    def l2_read_bytes(self, members, solution: ScheduleSolution, tilings) -> float:
        """Bytes a GPU kernel's blocks read from the L2: every plan block
        of a row-split dot reads its batch of the rhs whole, once for each
        row tile it stages (``geometry.DotTiling``)."""
        out = 0.0
        blocks = max(1, solution.blocks)
        for m in members:
            sched = solution.assignment.get(m.id, REPLICATED)
            if not is_row_split_dot(m, sched):
                continue
            rhs = m.operands[1]
            batch = max(1, int(np.prod(rhs.shape[:-2], dtype=np.int64)))
            t = tilings.get(m.id)
            rows = chunk_shape(m.shape, sched)[-2]
            out += blocks * (rows // t.bm if t is not None else -(-rows // 4)) * rhs.bytesize / batch
        return out

    # ---- per-op (the PerfLibrary miss handler, paper §4.4) ---------------
    def peak_for(self, instr: Instruction) -> float:
        if instr.opcode == "dot":
            return (
                self.rates.peak_flops_bf16
                if np.dtype(instr.dtype).itemsize <= 2
                else self.rates.peak_flops_f32
            )
        return self.rates.vpu_flops

    def op_time(self, instr: Instruction, sched: Sched, launch_blocks: int) -> float:
        """Time for ONE op under ``sched`` inside a kernel with
        ``launch_blocks`` grid steps (seconds), at the whole device's rates:
        ``fusion_time`` charges a kernel's grid by the share of the card it
        fills."""
        spec = self.rates
        chunk = chunk_shape(instr.shape, sched)
        replicated = sched.kind == "replicated"
        copies = launch_blocks if replicated else 1
        elems = int(np.prod(chunk, dtype=np.int64)) if chunk else 1
        itemsize = np.dtype(instr.dtype).itemsize
        total_elems = elems * (launch_blocks if not replicated else copies)
        # bytes: write output once per copy + read operands
        bytes_moved = total_elems * itemsize
        for o in instr.operands:
            o_elems = o.num_elements if replicated else o.num_elements / max(
                1, blocks_of(o.shape, sched) if sched.kind == "chunked" else 1
            )
            bytes_moved += o_elems * np.dtype(o.dtype).itemsize * copies
        flops = instr_flops(instr) * (copies if replicated else 1)
        eff = _lane_efficiency(chunk, spec)
        t_compute = flops / (self.peak_for(instr) * eff)
        t_memory = bytes_moved / (spec.hbm_bw * eff)
        return max(t_compute, t_memory)

    def kernel_time(self, num_blocks: int, op_times_sum: float) -> float:
        return (
            self.rates.launch_overhead_s
            + self.waves(num_blocks) * self.rates.grid_step_overhead_s
            + op_times_sum
        )

    # ---- per-kernel estimates (the fusion planner's currency) ------------
    def standalone_time(self, instr: Instruction) -> float:
        """One unfused kernel launch computing ``instr`` whole (on a GPU a
        PyTorch kernel, which fills the card)."""
        if instr.opcode in ("parameter", "constant"):
            return 0.0
        spec = self.rates
        body = 0.0
        if not is_trivial(instr):
            body = max(
                instr_flops(instr) / self.peak_for(instr),
                instr_hbm_bytes(instr) / spec.hbm_bw,
            )
        else:
            body = instr_hbm_bytes(instr) / spec.hbm_bw
        return (
            spec.launch_overhead_s + spec.grid_step_overhead_s + body
        )

    def _copies(self, operand: Instruction, blocks: int, sched: Sched) -> int:
        """Reads of a kernel input: one per block where it is replicated
        across a multi-block grid (on a GPU only past the L2)."""
        if blocks <= 1 or sched.kind != "replicated":
            return 1
        if self.rates.sm_count > 1 and operand.bytesize <= self.rates.l2_bytes:
            return 1
        return blocks

    def _phase_time(self, members: Sequence[Instruction], solution: ScheduleSolution, memory,
                    launch: Optional[PhaseLaunch], kernel_ids, outputs, seen_inputs: set,
                    read) -> Tuple[float, float]:
        """(body, grid steps) of one phase of a kernel running ``members``
        under ``solution``: max(compute, HBM) plus the VMEM traffic of
        buffered interior values, and the grid's steps.  ``kernel_ids`` are
        the kernel's members, whose values are no input; ``outputs`` the
        members it writes to HBM; ``seen_inputs`` the inputs already
        charged; ``read(o)`` the bytes a kernel input costs.  On a GPU,
        ``memory`` (the phase's ``MemoryPlan``) decides which slots
        round-trip through shared memory and what the shrunk members
        recompute, and ``launch`` (``geometry``) the grid and each dot's
        loop."""
        spec = self.rates
        gpu = spec.sm_count > 1
        blocks = max(1, solution.blocks)
        phase_ids = {m.id for m in members}
        tilings = launch.tilings if gpu else {}
        compute_s = 0.0
        hbm_bytes = 0.0
        vmem_bytes = 0.0
        for m in members:
            sched = solution.assignment.get(m.id, REPLICATED)
            dup = blocks if (blocks > 1 and sched.kind == "replicated") else 1
            if not is_trivial(m):
                eff = _lane_efficiency(chunk_shape(m.shape, sched), spec)
                if (gpu and m.opcode == "dot" and tilings.get(m.id) is None
                        and rhs_read_across_lanes(m, phase_ids, memory)):
                    eff *= np.dtype(m.operands[1].dtype).itemsize / SECTOR_BYTES
                compute_s += dup * instr_flops(m) / (self.peak_for(m) * eff)
            for o in m.operands:
                if o.id in kernel_ids or o.id in seen_inputs:
                    continue
                seen_inputs.add(o.id)
                hbm_bytes += read(o)
            if m.id in outputs:
                hbm_bytes += m.bytesize
            elif gpu and memory is not None:
                if memory.action(m) != "INLINE" and m.opcode != "constant":
                    vmem_bytes += 2 * dup * m.bytesize   # a slot's write and read
            elif m.opcode in ("reduce", "dot", "cumsum") and any(
                u.id in phase_ids for u in m.users
            ):
                # interior values memory.plan_memory marks as required
                # buffers: they round-trip through VMEM scratch
                vmem_bytes += dup * m.bytesize
        if not gpu:
            body = max(compute_s, hbm_bytes / spec.hbm_bw) + vmem_bytes / spec.vmem_bw
            return body, blocks * spec.grid_step_overhead_s
        grid = launch.grid
        cs = self.compute_share(grid)
        compute_s += self.recompute_s(members, memory, tilings, solution.assignment)
        l2 = self.l2_read_bytes(members, solution, tilings)
        body = (
            max(compute_s / cs, hbm_bytes / (spec.hbm_bw * self.hbm_share(grid)),
                l2 / (spec.l2_bw * cs) if l2 else 0.0)
            + vmem_bytes / (spec.vmem_bw * cs)
        )
        return body, self.waves(grid, launch.threads) * spec.grid_step_overhead_s

    def fusion_time(
        self,
        members: Sequence[Instruction],
        roots: Sequence[Instruction],
        solution: ScheduleSolution,
        memory=None,
    ) -> float:
        """One stitched kernel running ``members`` under ``solution``.

        Charges launch + grid steps, max(compute, HBM) for the body, VMEM
        traffic for buffered interior values, and replication duplication
        (see module docstring for the full convention list).  A kernel
        input replicated across the grid is read once per block
        (``_copies``).  On a GPU, ``memory`` (the fusion's ``MemoryPlan``)
        decides the launch (``geometry.fusion_launch``), which slots
        round-trip through shared memory, and what the shrunk members
        recompute.
        """
        spec = self.rates
        blocks = max(1, solution.blocks)
        member_ids = {m.id for m in members}
        launch = fusion_launch(members, roots, solution, memory) if spec.sm_count > 1 else None
        body, steps = self._phase_time(
            members, solution, memory, launch, member_ids, {r.id for r in roots}, set(),
            lambda o: self._copies(o, blocks, solution.assignment.get(o.id, REPLICATED)) * o.bytesize)
        return spec.launch_overhead_s + steps + body

    def stitched_fusion_time(self, stitched: StitchedSolution, memory=None) -> float:
        """ONE multi-phase stitched kernel (schedule.resolve_stitched).

        Charges a single launch, then per phase: the phase body (same terms
        as ``fusion_time``, but every input read exactly once as a whole
        tensor), the phase's sequential grid-loop steps, and a
        ``phase_loop_overhead_s`` transition.  Interface tensors are charged
        a full write + read round trip through VMEM — the staging traffic
        that replaces an HBM round trip plus a kernel launch under a split
        (on a GPU through the global workspace, at ``hbm_bw``, and a grid
        barrier between phases).  Phases are sequential: no overlap is
        assumed across them.  On a GPU, ``memory`` (the
        ``StitchedMemoryPlan``) decides each phase's launch
        (``geometry.stitched_launch``) and slots.
        """
        spec = self.rates
        gpu = spec.sm_count > 1
        group_ids = {m.id for p in stitched.phases for m in p.members}
        outputs = {m.id for p in stitched.phases for m in p.members
                   if not m.users or any(u.id not in group_ids for u in m.users)}
        total = spec.launch_overhead_s
        seen_inputs = set()
        launches = stitched_launch(stitched, memory) if gpu else None
        for k, p in enumerate(stitched.phases):
            pplan = memory.phase_plans[k] if (gpu and memory is not None) else None
            body, steps = self._phase_time(p.members, p.solution, pplan,
                                           launches[k] if gpu else None, group_ids, outputs,
                                           seen_inputs, lambda o: o.bytesize)
            # on a GPU the first phase starts with the launch, no transition
            total += body + steps + (spec.phase_loop_overhead_s if k or not gpu else 0.0)
        if gpu:
            # interface staging: written whole to the global workspace by
            # the producer phase, read back re-tiled by the consumer
            return total + 2.0 * stitched.interface_bytes / spec.hbm_bw
        # interface staging: one full write by the producer phase, one full
        # re-tiled read by the consumer phase, both through VMEM
        total += 2.0 * stitched.interface_bytes / spec.vmem_bw
        return total

    # ---- module-level roofline terms (launch/roofline.py) ----------------
    def compute_time(self, flops: float, chips: int = 1) -> float:
        return flops / (chips * self.rates.peak_flops_bf16)

    def memory_time(self, nbytes: float, chips: int = 1) -> float:
        return nbytes / (chips * self.rates.hbm_bw)

    def collective_time(self, nbytes: float, chips: int = 1) -> float:
        return nbytes / (chips * self.rates.ici_bw)

    # ---- per-collective-op time (shard-aware plans) ----------------------
    def collective_op_time(self, instr: Instruction, group_size: int) -> float:
        """One collective instruction over a ``group_size``-device axis
        group.  Ring algorithms move ``2*(n-1)/n`` of the payload per device
        for all-reduce and ``(n-1)/n`` for all-gather/reduce-scatter, plus a
        fixed per-collective sync latency.  This is what a collective costs
        the plan — it is a schedule break, never a kernel launch.  Raises
        ``NotMeasured`` where the spec has no link numbers
        (``prices_collectives``)."""
        n = max(1, int(group_size))
        payload = float(instr.bytesize)
        if instr.opcode == "all_reduce":
            wire = 2.0 * (n - 1) / n * payload
        else:  # all_gather / reduce_scatter: payload is the larger tensor
            big = max(payload, float(instr.operands[0].bytesize))
            wire = (n - 1) / n * big
        return self.rates.ici_latency_s + wire / self.rates.ici_bw

