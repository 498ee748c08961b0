"""Canonical fusion signatures + the kernel cache.

Stacked transformer graphs contain N structurally-identical fusions (one per
layer): same opcodes, shapes, dtypes, attrs and internal wiring, differing
only in *which* parameters/intermediates bind to the fusion inputs.  The
follow-up FusionStitching work (arXiv:2009.10924) and the XLA fusion study
(arXiv:2301.13062) both identify duplicate-fusion deduplication as the main
compile-latency lever at production scale.

``fusion_signature`` canonicalizes a ``FusedComputation`` *parameterized over
its input bindings*: members are numbered in topological order, inputs in
first-use order, and every operand reference becomes ("m", k) or ("in", k).
Two fusions get equal signatures iff they would tune to the same schedule,
get the same memory plan, and emit byte-identical kernels — so the tuned
solution and the emitted Pallas callable can be shared.

``KernelCache`` maps signatures to compiled entries.  It is in-memory per
compile (and shareable across compiles), with optional on-disk persistence
of the *tuned schedule choice* — the same JSON KV protocol as PerfLibrary —
so a warm process skips schedule tuning entirely and only re-emits kernels.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fusion import FusedComputation
from .memory import MemoryPlan
from .perf_library import JsonStore
from .schedule import Sched, ScheduleSolution


def _canon_value(v):
    """Canonical, hashable form of one attr value (ndarrays by content)."""
    if isinstance(v, np.ndarray):
        return (
            "ndarray",
            tuple(v.shape),
            str(v.dtype),
            hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest(),
        )
    if isinstance(v, (tuple, list)):
        return tuple(_canon_value(x) for x in v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return repr(v)


def _canon_attrs(attrs: Dict) -> Tuple:
    return tuple(sorted((k, _canon_value(v)) for k, v in attrs.items()))


def fusion_signature(fusion: FusedComputation) -> str:
    """Content hash of a fusion's structure, independent of input bindings.

    Covers: per-input (shape, dtype); per-member (opcode, shape, dtype,
    canonical attrs, operand references as member/input ordinals, root-ness);
    and the planner's committed phase structure (``stitch_phases``) — a
    multi-phase stitched lowering and a single-schedule lowering of the same
    member graph must never alias in the kernel cache.
    Instruction ids and names never enter the hash.
    """
    inputs = fusion.inputs
    members = fusion.members
    in_pos = {i.id: k for k, i in enumerate(inputs)}
    mem_pos = {m.id: k for k, m in enumerate(members)}
    root_ids = {r.id for r in fusion.roots}

    # Input features carry the shard layout when one is stamped: per-shard
    # member shapes are already local, but a fusion fed by a model-sharded
    # parameter and one fed by a replicated parameter of the same local shape
    # must never alias in the cache.  The entry is appended only when
    # non-trivial so unsharded signatures stay byte-identical across versions.
    feats: List = [
        ("phases", tuple(fusion.stitch_phases) if fusion.stitch_phases else None),
        tuple(
            (tuple(i.shape), str(np.dtype(i.dtype)))
            + ((("shard", _canon_value(i.attrs["shard"])),) if i.attrs.get("shard") else ())
            for i in inputs
        ),
    ]
    for m in members:
        refs = tuple(
            ("m", mem_pos[o.id]) if o.id in mem_pos else ("in", in_pos[o.id])
            for o in m.operands
        )
        feats.append(
            (
                m.opcode,
                tuple(m.shape),
                str(np.dtype(m.dtype)),
                _canon_attrs(m.attrs),
                refs,
                m.id in root_ids,
            )
        )
    return hashlib.sha256(repr(feats).encode()).hexdigest()


def module_signature(module) -> str:
    """Content hash of a whole module's structure — opcode/shape/dtype/attrs
    and operand wiring in instruction order, plus parameter arity and root
    positions.  Instruction ids and *names* never enter the hash, so two
    loop bodies lowered from structurally identical jaxprs (stacked scan
    layers) hash equal and share one compiled sub-module
    (``pipeline.SubModulePass``).  Nested ``call`` bodies hash recursively;
    their ``body``/``compiled_body`` attrs (unstable object reprs) are
    replaced by the recursive signature."""
    pos: Dict[int, int] = {}
    feats: List = []
    n_params = 0
    for k, instr in enumerate(module.instructions):
        pos[instr.id] = k
        attrs = instr.attrs
        if instr.opcode == "call":
            attrs = {
                key: v for key, v in attrs.items()
                if key not in ("body", "compiled_body", "body_sig")
            }
            attrs["body_sig"] = module_signature(instr.attrs["body"])
        if instr.opcode == "parameter":
            n_params += 1
        feats.append(
            (
                instr.opcode,
                tuple(instr.shape),
                str(np.dtype(instr.dtype)),
                _canon_attrs(attrs),
                tuple(pos[o.id] for o in instr.operands),
            )
        )
    feats.append(("params", n_params))
    feats.append(("roots", tuple(pos[r.id] for r in module.roots)))
    return hashlib.sha256(repr(feats).encode()).hexdigest()


@dataclass
class CacheEntry:
    """One unique fusion structure: its tuned schedule, memory plan, and the
    emitted kernel (ids inside solution/memory refer to the representative
    instance the entry was built from; the kernel callable is positional and
    binds to any instance with the same signature).

    Multi-phase stitched fusions carry a ``stitched`` solution (and a
    ``StitchedMemoryPlan`` in ``memory``) instead of a single ``solution``;
    their tuning records are never persisted to disk — the root-schedule
    hint protocol only describes single-schedule kernels."""

    signature: str
    solution: Optional[ScheduleSolution]
    memory: Optional[MemoryPlan]
    cost_s: float
    kernel: Optional[object] = None      # StitchedKernel of the representative
    root_scheds: List[Sched] = field(default_factory=list)  # in root order
    kept_members: Optional[int] = None   # after memory-feedback shrink
    stitched: Optional[object] = None    # schedule.StitchedSolution
    # Autotuning bookkeeping: cost_s above is whatever the planner will act
    # on (measured when the store hit, analytic otherwise); these two keep
    # the provenance apart so CompileStats can report model error.
    model_cost_s: Optional[float] = None     # analytic LatencyModel seconds
    measured_cost_s: Optional[float] = None  # on-device seconds, if known

    @property
    def blocks(self) -> int:
        if self.stitched is not None:
            return self.stitched.blocks
        return self.solution.blocks


# Version of the on-disk tuning-record schema.  Bump whenever the persisted
# payload changes shape (fields, Sched encoding, cost semantics): records
# written under any other version are silently discarded on read instead of
# crashing a warm process on an unpacking error.
SCHEMA_VERSION = 2


def _sched_to_json(s: Sched) -> List:
    return [s.kind, s.split_dim, s.sword, s.sched_type]


def _sched_from_json(row) -> Sched:
    kind, split_dim, sword, sched_type = row
    return Sched(kind, int(split_dim), int(sword), sched_type)


class KernelCache:
    """Signature -> CacheEntry map with optional persistent tuning hints.

    The persistent layer stores only the tuned schedule decision (root
    schedules + predicted cost), not the kernel: Pallas callables are cheap
    to re-emit once tuning — the expensive search — is skipped.  Records
    carry a ``version`` field; stale or corrupt rows are dropped on read
    (``stale_discards`` counts them) rather than raised.
    """

    def __init__(self, path: Optional[str] = None):
        self._entries: Dict[str, CacheEntry] = {}
        self._disk = JsonStore(path)
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.stale_discards = 0

    # ---- in-memory entries ----------------------------------------------
    def get(self, signature: str) -> Optional[CacheEntry]:
        e = self._entries.get(signature)
        if e is not None:
            self.hits += 1
        else:
            self.misses += 1
        return e

    def put(self, entry: CacheEntry, persist: bool = True) -> None:
        self._entries[entry.signature] = entry
        if entry.stitched is not None:
            persist = False      # hint protocol is single-schedule only
        if persist and self._disk.path is not None:
            self._disk.put(
                entry.signature,
                {
                    "version": SCHEMA_VERSION,
                    "roots": [_sched_to_json(s) for s in entry.root_scheds],
                    "blocks": entry.solution.blocks,
                    "cost_s": entry.cost_s,
                },
            )

    def remove(self, signature: str) -> None:
        """Drop a dead entry everywhere (in-memory and persistent)."""
        self._entries.pop(signature, None)
        self._disk.pop(signature)

    def discard_disk(self, signature: str) -> None:
        """Invalidate only the persistent tuning record (e.g. after the
        memory-feedback loop shrank the fusion: the recorded schedules no
        longer describe the structure the signature hashes)."""
        self._disk.pop(signature)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, signature: str) -> bool:
        return signature in self._entries

    # ---- persistent tuning hints ----------------------------------------
    def tuning_hint(self, signature: str) -> Optional[List[Sched]]:
        """Root schedules recorded by a previous process, or None.

        A record from another schema version — or one that does not parse —
        is evicted and reported as a miss, so format changes degrade to a
        cold retune instead of a crash.
        """
        rec = self._disk.get(signature)
        if rec is None:
            return None
        try:
            if rec.get("version") != SCHEMA_VERSION:
                raise ValueError(f"schema version {rec.get('version')!r}")
            scheds = [_sched_from_json(r) for r in rec["roots"]]
        except (ValueError, TypeError, KeyError, AttributeError, IndexError):
            self._disk.pop(signature)
            self.stale_discards += 1
            return None
        self.disk_hits += 1
        return scheds

    def save(self) -> None:
        self._disk.save()
