"""The unified analytic latency model — ONE place for device constants and
roofline math.

``DeviceSpec`` is the single source of hardware constants
(``core/perf_library.py`` re-exports it as ``TpuSpec``) and
``LatencyModel`` is the one scoring object shared by the fusion planner
and the schedule tuner (through ``PerfLibrary.model``).  Two specs: the
planner scores every plan with ``TPU_V5E``, the reference's constants, so
the port's plans stay the reference's; ``H100`` holds the card's, from its
data sheet and from ``chip_smoke.py``'s measurements, and
``launch/roofline.py`` derives its peaks from it.

What the model charges (see README "LatencyModel conventions"):
  * one ``launch_overhead_s`` per kernel plus ``grid_step_overhead_s`` per
    grid program;
  * compute at roofline peak — MXU peak for dots (bf16 vs f32 by dtype),
    VPU-weighted flops for elementwise (``_EW_WEIGHT``) — derated by a
    lane-efficiency penalty when the chunk underfills the (8,128) tile;
  * HBM traffic for kernel inputs and root outputs; a replicated operand
    in a multi-block kernel is re-read per block;
  * VMEM traffic for buffered interior values (reduce / fusable-dot
    results — the same set ``memory.plan_memory`` marks required);
  * replication duplication: a replicated member of a multi-block kernel
    recomputes in every block.

What it approximates:
  * perfect overlap of compute and HBM DMA inside one kernel
    (``max(compute, memory)``, not the sum);
  * non-buffered interior elementwise values are free (thread
    composition re-computes them in registers);
  * no cross-block caching and no occupancy modeling — one TensorCore.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Sequence, Tuple

import numpy as np

from .ir import Instruction
from .schedule import (
    REPLICATED,
    Sched,
    ScheduleSolution,
    StitchedSolution,
    blocks_of,
    chunk_shape,
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

    def fingerprint(self) -> str:
        """Content hash of the hardware constants.  A measured kernel time is
        only meaningful relative to the device it was taken on, so the
        measured-cost tuning store (``core/measure.py``) keys every record by
        this fingerprint (combined with the runtime backend): a store carried
        to a different device spec degrades to all-misses — the analytic
        model — instead of replaying another chip's timings."""
        feats = tuple((f.name, getattr(self, f.name)) for f in fields(self))
        return hashlib.sha256(repr(feats).encode()).hexdigest()[:16]


TPU_V5E = DeviceSpec()

_NOT_MEASURED = float("nan")

#: NVIDIA H100 SXM5 80 GB.  Peaks and rates from the data sheet; the launch
#: and grid-step overheads measured by ``chip_smoke.py`` phase 17 (c) (the
#: device time of a one-block generated kernel, and what each further plan
#: block of the same work adds).  A field the card has no number for is NaN,
#: so a score that reads it is NaN, never another chip's value.
H100 = DeviceSpec(
    peak_flops_bf16=989e12,          # dense bf16 on the tensor cores
    peak_flops_f32=67e12,            # f32 without the tensor cores (TF32 off)
    vpu_flops=67e12,                 # elementwise f32 on the CUDA cores
    hbm_bw=3.35e12,                  # HBM3
    vmem_bw=_NOT_MEASURED,           # shared memory: no data-sheet figure
    vmem_bytes=232448,               # shared memory a block (codegen.SMEM_LIMIT)
    ici_bw=900e9,                    # NVLink 4, both directions summed (450 GB/s each way)
    ici_latency_s=_NOT_MEASURED,     # one card: no collective between cards measured
    # chip_smoke.py phase 17 (c) on an H100 (700 W): the generated exp
    # kernel's device time over (8, 256) f32 in one plan block, 1.150 µs;
    # over (8448, 256) f32 in 8 plan blocks against 1, (6.398 - 5.887) / 7 µs
    launch_overhead_s=1.15e-6,
    grid_step_overhead_s=7.3e-8,
    phase_loop_overhead_s=_NOT_MEASURED,  # a grid barrier alone is not measured
    # the (sublane, lane) tile is the TPU's vector register; a GPU has no
    # such tile: a warp of 32 threads is the nearest unit
    sublane=1,
    lane=32,
)

# VPU op weight: how many vector-op equivalents one element costs.
_EW_WEIGHT = {"add": 1, "sub": 1, "mul": 1, "max": 1, "min": 1, "neg": 1,
              "abs": 1, "sign": 1, "floor": 1, "not": 1, "and": 1, "or": 1,
              "lt": 1, "le": 1, "gt": 1, "ge": 1, "eq": 1, "ne": 1,
              "square": 1, "reciprocal": 4, "div": 4, "sqrt": 4, "rsqrt": 4,
              "exp": 8, "log": 8, "tanh": 12, "sigmoid": 10, "softplus": 12,
              "silu": 12, "gelu": 14, "pow": 16}

# Computationally trivial ops: inlined via thread composition during both
# schedule scoring (tuning.py) and planner scoring — charging them would
# veto good schedules (paper §4.3 optimization).
TRIVIAL_OPCODES = frozenset({"reshape", "bitcast", "broadcast", "constant", "iota"})
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
    if op == "reduce":
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


class LatencyModel:
    """Device spec + per-op / per-fusion / per-module time estimates.

    One instance is shared across the whole compile: the fusion planner
    scores candidate partitions, ``PerfLibrary`` uses ``op_time`` as its
    miss handler, ``tuning.score`` finishes with ``kernel_time``, and
    ``launch/roofline.py`` builds its table from the ``*_time`` roofline
    terms — all against the same ``DeviceSpec``.
    """

    def __init__(self, spec: DeviceSpec = TPU_V5E):
        self.spec = spec

    # ---- per-op (the PerfLibrary miss handler, paper §4.4) ---------------
    def peak_for(self, instr: Instruction) -> float:
        if instr.opcode == "dot":
            return (
                self.spec.peak_flops_bf16
                if np.dtype(instr.dtype).itemsize <= 2
                else self.spec.peak_flops_f32
            )
        return self.spec.vpu_flops

    def op_time(self, instr: Instruction, sched: Sched, launch_blocks: int) -> float:
        """Time for ONE op under ``sched`` inside a kernel with
        ``launch_blocks`` grid steps (seconds)."""
        spec = self.spec
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
            self.spec.launch_overhead_s
            + num_blocks * self.spec.grid_step_overhead_s
            + op_times_sum
        )

    # ---- per-kernel estimates (the fusion planner's currency) ------------
    def standalone_time(self, instr: Instruction) -> float:
        """One unfused kernel launch computing ``instr`` whole."""
        if instr.opcode in ("parameter", "constant"):
            return 0.0
        body = 0.0
        if not is_trivial(instr):
            body = max(
                instr_flops(instr) / self.peak_for(instr),
                instr_hbm_bytes(instr) / self.spec.hbm_bw,
            )
        else:
            body = instr_hbm_bytes(instr) / self.spec.hbm_bw
        return (
            self.spec.launch_overhead_s + self.spec.grid_step_overhead_s + body
        )

    def fusion_time(
        self,
        members: Sequence[Instruction],
        roots: Sequence[Instruction],
        solution: ScheduleSolution,
    ) -> float:
        """One stitched kernel running ``members`` under ``solution``.

        Charges launch + grid steps, max(compute, HBM) for the body, VMEM
        traffic for buffered interior values, and replication duplication
        (see module docstring for the full convention list).
        """
        spec = self.spec
        blocks = max(1, solution.blocks)
        member_ids = {m.id for m in members}
        root_ids = {r.id for r in roots}
        compute_s = 0.0
        hbm_bytes = 0.0
        vmem_bytes = 0.0
        seen_inputs = set()
        for m in members:
            sched = solution.assignment.get(m.id, REPLICATED)
            dup = blocks if (blocks > 1 and sched.kind == "replicated") else 1
            if not is_trivial(m):
                eff = _lane_efficiency(chunk_shape(m.shape, sched), spec)
                compute_s += dup * instr_flops(m) / (self.peak_for(m) * eff)
            for o in m.operands:
                if o.id in member_ids or o.id in seen_inputs:
                    continue
                seen_inputs.add(o.id)
                osched = solution.assignment.get(o.id, REPLICATED)
                copies = blocks if (blocks > 1 and osched.kind == "replicated") else 1
                hbm_bytes += copies * o.bytesize
            if m.id in root_ids:
                hbm_bytes += m.bytesize
            elif m.opcode in ("reduce", "dot") and any(
                u.id in member_ids for u in m.users
            ):
                # interior values memory.plan_memory marks as required
                # buffers: they round-trip through VMEM scratch
                vmem_bytes += dup * m.bytesize
        body = max(compute_s, hbm_bytes / spec.hbm_bw) + vmem_bytes / spec.vmem_bw
        return (
            spec.launch_overhead_s
            + blocks * spec.grid_step_overhead_s
            + body
        )

    def stitched_fusion_time(self, stitched: StitchedSolution) -> float:
        """ONE multi-phase stitched kernel (schedule.resolve_stitched).

        Charges a single launch, then per phase: the phase body (same terms
        as ``fusion_time``), the phase's sequential grid-loop steps, and a
        ``phase_loop_overhead_s`` transition.  Interface tensors are charged
        a full write + read round trip through VMEM — the staging traffic
        that replaces an HBM round trip plus a kernel launch under a split.
        Phases are sequential: no overlap is assumed across them.
        """
        spec = self.spec
        group_ids = {m.id for p in stitched.phases for m in p.members}
        total = spec.launch_overhead_s
        seen_inputs = set()
        for p in stitched.phases:
            blocks = max(1, p.solution.blocks)
            phase_ids = {m.id for m in p.members}
            compute_s = 0.0
            hbm_bytes = 0.0
            vmem_bytes = 0.0
            for m in p.members:
                sched = p.solution.assignment.get(m.id, REPLICATED)
                dup = blocks if (blocks > 1 and sched.kind == "replicated") else 1
                if not is_trivial(m):
                    eff = _lane_efficiency(chunk_shape(m.shape, sched), spec)
                    compute_s += dup * instr_flops(m) / (self.peak_for(m) * eff)
                for o in m.operands:
                    if o.id in group_ids or o.id in seen_inputs:
                        continue   # phase-local, staged, or already-read input
                    seen_inputs.add(o.id)
                    # stitched kernels read every input exactly ONCE as a
                    # whole-tensor block (grid is trivial); unlike
                    # fusion_time there is no per-block re-read to charge
                    hbm_bytes += o.bytesize
                if not m.users or any(u.id not in group_ids for u in m.users):
                    hbm_bytes += m.bytesize          # kernel output
                elif m.opcode in ("reduce", "dot") and any(
                    u.id in phase_ids for u in m.users
                ):
                    vmem_bytes += dup * m.bytesize   # phase-interior buffer
            total += (
                max(compute_s, hbm_bytes / spec.hbm_bw)
                + vmem_bytes / spec.vmem_bw
                + blocks * spec.grid_step_overhead_s
                + spec.phase_loop_overhead_s
            )
        # interface staging: one full write by the producer phase, one full
        # re-tiled read by the consumer phase, both through VMEM
        total += 2.0 * stitched.interface_bytes / spec.vmem_bw
        return total

    # ---- module-level roofline terms (launch/roofline.py) ----------------
    def compute_time(self, flops: float, chips: int = 1) -> float:
        return flops / (chips * self.spec.peak_flops_bf16)

    def memory_time(self, nbytes: float, chips: int = 1) -> float:
        return nbytes / (chips * self.spec.hbm_bw)

    def collective_time(self, nbytes: float, chips: int = 1) -> float:
        return nbytes / (chips * self.spec.ici_bw)

    # ---- per-collective-op time (shard-aware plans) ----------------------
    def collective_op_time(self, instr: Instruction, group_size: int) -> float:
        """One collective instruction over a ``group_size``-device axis
        group.  Ring algorithms move ``2*(n-1)/n`` of the payload per device
        for all-reduce and ``(n-1)/n`` for all-gather/reduce-scatter, plus a
        fixed per-collective sync latency.  This is what a collective costs
        the plan — it is a schedule break, never a kernel launch."""
        n = max(1, int(group_size))
        payload = float(instr.bytesize)
        if instr.opcode == "all_reduce":
            wire = 2.0 * (n - 1) / n * payload
        else:  # all_gather / reduce_scatter: payload is the larger tensor
            big = max(payload, float(instr.operands[0].bytesize))
            wire = (n - 1) / n * big
        return self.spec.ici_latency_s + wire / self.spec.ici_bw
