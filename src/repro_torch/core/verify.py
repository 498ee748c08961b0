"""Pass-boundary StitchIR verifier and ExecutionPlan linter of the port —
``repro/core/verify.py``.

After a pass runs, ``verify_state`` re-derives the invariants the pipeline
is supposed to keep and reports each violation as a ``Diagnostic`` naming
the rule, the offending instruction, fusion or slot, and the pass boundary
it was found at, so a broken plan fails at its source and not as a wrong
number later.  Three families, as in the reference:

* **IR well-formedness** (``IR0xx``, ``verify_module``): def-before-use,
  topological storage order, operand/user back-edge symmetry, unique ids,
  shape and dtype re-inference, and the attr-declared contracts of
  ``call``/``get``/``constant``.  ``Module.verify()`` delegates here.
* **Plan lint** (``PLAN0xx``): fusion groups are acyclic, never span an LC
  layer (``core/span.py``), hold no collective, library call, loop or
  array constant; every instruction is covered exactly once; the stamped
  shard layouts of a sharded compile equal a fresh derivation (PLAN007)
  and no partial sum reaches a root unclosed (PLAN008,
  ``verify_shard_attrs``); each planned
  entry's schedule solution is sound (per phase for stitched plans); and
  its memory plan fits the port's budgets (PLAN006): the plan's bytes
  within ``options.vmem_limit``, the budget the planner planned against,
  and each emitted kernel's shared memory a block within what a Hopper
  block may use (``geometry.SMEM_LIMIT``).
* **ExecutionPlan lint** (``EXEC0xx``, ``verify_execution_plan``): a
  dataflow walk over the slot table (every slot written before it is read,
  never read after its release point, releases sane), the CUDA-graph audit
  that takes the place of the reference's donation audit (EXEC004: no
  parameter slot, the caller's feed, and no template slot, a folded
  constant, is written by a step or released into a graph's memory pool,
  and every slot a graph releases into its pool is dead after), and the
  kernel-cache signature audit (EXEC005).

``PassPipeline.run`` calls ``verify_state`` as ``StitchOptions.verify``
says (``off``, ``checkpoint``, ``strict``), and ``REPRO_VERIFY`` overrides
the option.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import span as span_lib
from .fusion import constant_like
from .geometry import SMEM_LIMIT
from .ir import Instruction, Module, as_dtype, dtype_name, infer_dtype, infer_shape
from .schedule import Unsatisfiable, blocks_of, propagate

ERROR = "error"
WARNING = "warning"

VERIFY_MODES = ("off", "checkpoint", "strict")
VERIFY_ENV_VAR = "REPRO_VERIFY"

#: rule id -> one-line description, the reference's rules
RULES: Dict[str, str] = {
    "IR001": "operand is not an instruction of this module (dangling def)",
    "IR002": "operand stored after its user (topological order broken)",
    "IR003": "operand/user back-edges are asymmetric",
    "IR004": "duplicate instruction id in one module",
    "IR005": "recorded shape disagrees with shape re-inference",
    "IR006": "recorded dtype disagrees with dtype re-inference",
    "IR007": "attr-declared shape/dtype contract broken (call/get/constant/slice/cumsum)",
    "IR008": "duplicate parameter name",
    "PLAN001": "fusion group is cyclic through outside instructions or groups",
    "PLAN002": "fusion component spans an LC layer roof",
    "PLAN003": "forbidden member in a kernel body (collective/library/loop)",
    "PLAN004": "non-scalar constant inside a kernel body",
    "PLAN005": "schedule solution unsound for its fusion",
    "PLAN006": "memory plan exceeds its budget (plan bytes or a block's shared memory)",
    "PLAN007": "stamped shard layout disagrees with re-derivation",
    "PLAN008": "partial sum reaches a module root unclosed",
    "PLAN009": "instruction not covered exactly once by the plan",
    "EXEC001": "slot read before written / written twice",
    "EXEC002": "slot read after its eager-release point",
    "EXEC003": "bad release (root slot, double release, never written)",
    "EXEC004": "protected slot written or released into a graph's pool, or a pool slot still live",
    "EXEC005": "cache entry signature does not match its lowered body",
}


@dataclass(frozen=True)
class Diagnostic:
    """One structured verifier finding.  ``subject`` names the offending
    instruction / fusion / slot; ``pass_name`` is the pass boundary it was
    found at (empty when the verifier ran standalone)."""

    severity: str                 # ERROR | WARNING
    rule: str                     # key into RULES
    message: str
    subject: str = ""
    pass_name: str = ""

    def __str__(self) -> str:
        where = f" [{self.subject}]" if self.subject else ""
        origin = f" (after pass {self.pass_name!r})" if self.pass_name else ""
        return f"{self.severity} {self.rule}{where}: {self.message}{origin}"


class VerificationError(ValueError):
    """Raised when verification finds error-severity diagnostics."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        shown = "\n".join(f"  {d}" for d in self.diagnostics[:12])
        more = len(self.diagnostics) - 12
        if more > 0:
            shown += f"\n  ... and {more} more"
        super().__init__(f"{len(self.diagnostics)} verifier diagnostic(s):\n{shown}")


def resolve_verify_mode(options) -> str:
    """The effective verify level: ``REPRO_VERIFY`` first, then
    ``options.verify``."""
    env = os.environ.get(VERIFY_ENV_VAR)
    if env:
        if env not in VERIFY_MODES:
            raise ValueError(f"{VERIFY_ENV_VAR}={env!r}: valid values are {', '.join(VERIFY_MODES)}")
        return env
    mode = getattr(options, "verify", "checkpoint")
    if mode not in VERIFY_MODES:
        raise ValueError(f"options.verify={mode!r}: valid values are {', '.join(VERIFY_MODES)}")
    return mode


# --------------------------------------------------------------------------
# Family 1: IR well-formedness
# --------------------------------------------------------------------------


def verify_module(module: Module, pass_name: str = "", _prefix: str = "") -> List[Diagnostic]:
    """IR well-formedness diagnostics for one module and, recursively, the
    body modules of its ``call`` loops."""
    diags: List[Diagnostic] = []

    def err(rule: str, subject: str, message: str) -> None:
        diags.append(Diagnostic(ERROR, rule, message, _prefix + subject, pass_name))

    index: Dict[int, int] = {}
    for pos, instr in enumerate(module.instructions):
        if instr.id in index:
            err("IR004", instr.name,
                f"id {instr.id} already used by {module.instructions[index[instr.id]].name}")
        else:
            index[instr.id] = pos

    param_names: Set[str] = set()
    for pos, instr in enumerate(module.instructions):
        if instr.opcode == "parameter":
            if instr.name in param_names:
                err("IR008", instr.name, "duplicate parameter name")
            param_names.add(instr.name)
        for op in instr.operands:
            at = index.get(op.id)
            if at is None:
                err("IR001", instr.name, f"operand {op.name} is not an instruction of module {module.name!r}")
            elif at >= pos:
                err("IR002", instr.name, f"operand {op.name} stored at position {at}, after its user at {pos}")
        for op in set(instr.operands):
            uses = sum(1 for o in instr.operands if o.id == op.id)
            backs = sum(1 for u in op.users if u.id == instr.id)
            if uses != backs:
                err("IR003", instr.name, f"lists operand {op.name} {uses}x but appears in its users {backs}x")
        for u in instr.users:
            if u.id not in index:
                err("IR003", instr.name,
                    f"user {u.name} is not an instruction of module {module.name!r} (stale back-edge)")
        diags.extend(
            Diagnostic(ERROR, rule, msg, _prefix + instr.name, pass_name)
            for rule, msg in _check_instr_types(instr)
        )

    for instr in module.instructions:
        if instr.opcode == "call":
            body = instr.attrs.get("body")
            if isinstance(body, Module):
                diags.extend(verify_module(body, pass_name, _prefix=f"{_prefix}{instr.name}/"))
    return diags


def _check_instr_types(instr: Instruction) -> List[Tuple[str, str]]:
    """Shape/dtype re-inference plus the attr-declared contracts of the
    opcodes ``infer_shape`` skips.  Returns (rule, message) pairs."""
    out: List[Tuple[str, str]] = []
    try:
        shape = infer_shape(instr.opcode, [o.shape for o in instr.operands], instr.attrs)
    except (ValueError, AssertionError, KeyError, IndexError) as e:
        out.append(("IR005", f"shape inference failed: {e}"))
        shape = None
    if shape is not None and tuple(shape) != tuple(instr.shape):
        out.append(("IR005", f"recorded shape {instr.shape} != inferred {tuple(shape)}"))
    try:
        dtype = infer_dtype(instr.opcode, [o.dtype for o in instr.operands], instr.attrs)
    except (ValueError, KeyError, IndexError) as e:
        out.append(("IR006", f"dtype inference failed: {e}"))
        dtype = None
    if dtype is not None and np.dtype(dtype) != np.dtype(instr.dtype):
        out.append(("IR006", f"recorded dtype {dtype_name(instr.dtype)} != inferred {dtype_name(dtype)}"))

    a = instr.attrs
    if instr.opcode == "slice":
        for d, (lo, hi, st) in enumerate(zip(a["starts"], a["limits"], a["strides"])):
            if not (0 <= lo <= hi <= instr.operands[0].shape[d] and st >= 1):
                out.append(("IR007", f"slice window {lo}:{hi}:{st} of dim {d} is not inside "
                                     f"its operand's {instr.operands[0].shape[d]}"))
    elif instr.opcode == "cumsum" and not 0 <= a.get("dim", -1) < instr.ndim:
        out.append(("IR007", f"cumsum along dim {a.get('dim')} of a rank-{instr.ndim} value"))
    elif instr.opcode == "constant":
        value = a.get("value")
        if value is None:
            out.append(("IR007", "constant without a value attr"))
        elif tuple(np.shape(value)) != tuple(instr.shape):
            out.append(("IR007", f"value shape {np.shape(value)} != recorded {instr.shape}"))
    elif instr.opcode == "call":
        out.extend(_check_call(instr))
    elif instr.opcode == "get":
        src = instr.operands[0] if instr.operands else None
        if src is None or src.opcode != "call":
            out.append(("IR007", "get must project a call instruction"))
        else:
            idx = int(a.get("index", -1))
            shapes = src.attrs.get("out_shapes", ())
            dtypes = src.attrs.get("out_dtypes", ())
            if not 0 <= idx < len(shapes):
                out.append(("IR007", f"index {idx} out of range for {len(shapes)} outputs"))
            else:
                if tuple(shapes[idx]) != tuple(instr.shape):
                    out.append(("IR007", f"recorded shape {instr.shape} != declared "
                                         f"out_shapes[{idx}] {tuple(shapes[idx])}"))
                if as_dtype(dtypes[idx]) != np.dtype(instr.dtype):
                    out.append(("IR007", f"recorded dtype {dtype_name(instr.dtype)} != "
                                         f"declared out_dtypes[{idx}]"))
    return out


def _check_call(instr: Instruction) -> List[Tuple[str, str]]:
    """The ``call`` loop contract: declared outputs index real body roots,
    carries close their shape loop, xs stack over the trip count."""
    out: List[Tuple[str, str]] = []
    a = instr.attrs
    body = a.get("body")
    if not isinstance(body, Module):
        return [("IR007", "call without a body module")]
    try:
        nc, k = int(a["num_consts"]), int(a["num_carry"])
        trip = int(a["trip_count"])
        order = tuple(a["out_order"])
        shapes = tuple(a["out_shapes"])
        dtypes = tuple(a["out_dtypes"])
    except (KeyError, TypeError, ValueError) as e:
        return [("IR007", f"call attrs incomplete: {e}")]
    if not (len(order) == len(shapes) == len(dtypes)):
        return [("IR007", f"out_order/out_shapes/out_dtypes lengths disagree: "
                          f"{len(order)}/{len(shapes)}/{len(dtypes)}")]
    roots = body.roots
    for j in order:
        if not 0 <= j < len(roots):
            return [("IR007", f"out_order entry {j} out of range for {len(roots)} body roots")]
    if k > len(order):
        return [("IR007", f"num_carry {k} > {len(order)} declared outputs")]
    if nc + k > len(instr.operands):
        return [("IR007", f"num_consts+num_carry {nc + k} > {len(instr.operands)} operands")]
    if tuple(instr.shape) != tuple(shapes[0]) or as_dtype(dtypes[0]) != np.dtype(instr.dtype):
        out.append(("IR007", "call instr shape/dtype must alias out_shapes[0]/out_dtypes[0]"))
    for i in range(k):
        init = instr.operands[nc + i]
        if tuple(init.shape) != tuple(shapes[i]):
            out.append(("IR007", f"carry {i}: init {init.name} shape {init.shape} != "
                                 f"declared {tuple(shapes[i])}"))
        if tuple(roots[order[i]].shape) != tuple(shapes[i]):
            out.append(("IR007", f"carry {i}: body root shape {roots[order[i]].shape} != "
                                 f"declared {tuple(shapes[i])}"))
    for j in range(k, len(order)):
        want = (trip,) + tuple(roots[order[j]].shape)
        if tuple(shapes[j]) != want:
            out.append(("IR007", f"ys output {j}: declared {tuple(shapes[j])} != (trip,)+root shape {want}"))
    for xs in instr.operands[nc + k:]:
        if not xs.shape or int(xs.shape[0]) != trip:
            out.append(("IR007", f"xs operand {xs.name} leading dim {xs.shape[:1] or '()'} "
                                 f"!= trip_count {trip}"))
    return out


# --------------------------------------------------------------------------
# Family 2: plan lint
# --------------------------------------------------------------------------


def verify_fusion_groups(fusions, standalone, module: Module, pass_name: str = "") -> List[Diagnostic]:
    """Structural lint of a fusion partition: acyclic groups, LC-layer
    roofs, member legality, exactly-once coverage."""
    from .fusion import _group_cycle, _groups_of

    diags: List[Diagnostic] = []
    span = span_lib.compute_spans(module)
    lcs = span_lib.lc_spans(module, span)
    max_span = max(span.values()) if span else 0

    def err(rule: str, subject: str, message: str) -> None:
        diags.append(Diagnostic(ERROR, rule, message, subject, pass_name))

    group_of = _groups_of(list(fusions))
    for f in fusions:
        members = list(f.members)
        if _group_cycle(set(members), group_of):
            err("PLAN001", f.name, "member union reaches itself through outside instructions")
        for m in members:
            if m.is_collective:
                err("PLAN003", f.name, f"collective {m.name} inside a kernel body")
            elif m.is_library_call or m.opcode in ("call", "get", "parameter"):
                err("PLAN003", f.name, f"{m.opcode} {m.name} inside a kernel body")
            elif m.opcode == "constant" and m.num_elements != 1:
                err("PLAN004", f.name, f"array constant {m.name} ({m.num_elements} elements) "
                                       "inside a kernel body; the emitters inline scalars only")
        # LC roofs hold per weakly-connected component of member edges: a
        # horizontal merge may pack independent towers from both sides of an
        # LC layer, but no dependent chain may cross a roof
        for comp in _member_components(members):
            spans_c = [span[m.id] for m in comp if m.id in span]
            if not spans_c:
                continue
            roof = span_lib.roof_for(min(spans_c), lcs, max_span)
            if max(spans_c) > roof:
                names = ", ".join(m.name for m in comp[:4])
                err("PLAN002", f.name, f"component [{names}...] spans layers "
                                       f"{min(spans_c)}..{max(spans_c)} past LC roof {roof}")

    counts: Dict[int, int] = {}
    for f in fusions:
        for m in f.members:
            counts[m.id] = counts.get(m.id, 0) + 1
    for s in standalone:
        counts[s.id] = counts.get(s.id, 0) + 1
    for instr in module.instructions:
        if instr.opcode in ("parameter", "constant") or constant_like(instr):
            continue
        n = counts.get(instr.id, 0)
        if n != 1:
            err("PLAN009", instr.name, f"covered {n}x by the plan (want exactly once)")
    return diags


def _member_components(members) -> List[List[Instruction]]:
    """Weakly-connected components of the member set under member-to-member
    operand edges, constant-like members dropped."""
    core = [m for m in members if not constant_like(m)]
    ids = {m.id for m in core}
    parent: Dict[int, int] = {m.id: m.id for m in core}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for m in core:
        for o in m.operands:
            if o.id in ids:
                parent[find(m.id)] = find(o.id)
    groups: Dict[int, List[Instruction]] = {}
    for m in core:
        groups.setdefault(find(m.id), []).append(m)
    return list(groups.values())


def _verify_solution(members, solution, blocks: int, subject: str, pass_name: str) -> List[Diagnostic]:
    """The ``resolve_schedules`` soundness contract, re-checked."""
    diags: List[Diagnostic] = []

    def err(message: str) -> None:
        diags.append(Diagnostic(ERROR, "PLAN005", message, subject, pass_name))

    assignment = solution.assignment
    for m in members:
        sched = assignment.get(m.id)
        if sched is None:
            err(f"member {m.name} has no schedule assignment")
            continue
        if sched.kind == "chunked" and blocks_of(m.shape, sched) != blocks:
            err(f"member {m.name}: {sched!r} yields {blocks_of(m.shape, sched)} blocks, "
                f"launch grid is {blocks}")
            continue
        try:
            needs = propagate(m, sched, row_split=True)
        except Unsatisfiable as e:
            err(f"member {m.name}: no propagation under {sched!r}: {e}")
            continue
        for o, osched in zip(m.operands, needs, strict=False):
            got = assignment.get(o.id)
            if got is None:
                err(f"member {m.name}: operand {o.name} unassigned")
            elif got != osched and got.kind != "replicated":
                err(f"member {m.name}: operand {o.name} has {got!r}, needs {osched!r}")
    return diags


def verify_planned_entries(state, pass_name: str = "") -> List[Diagnostic]:
    """Per-entry lint: schedule-solution soundness (per phase for stitched
    plans), the memory budgets (PLAN006) and the kernel-cache signature
    audit (EXEC005)."""
    from .pipeline import _options_fingerprint
    from .signature import fusion_signature

    diags: List[Diagnostic] = []
    opts = state.options
    salt = _options_fingerprint(opts, state.device)

    def err(rule: str, subject: str, message: str) -> None:
        diags.append(Diagnostic(ERROR, rule, message, subject, pass_name))

    for p in state.planned:
        fusion, entry = p.fusion, p.entry
        # shrunk instances keep their pre-shrink signature on purpose (the
        # entry records kept_members), so only the salt is checked for them
        if p.raw_signature is not None:
            if not p.shrunk and fusion_signature(fusion) != p.raw_signature:
                err("EXEC005", fusion.name, "fusion body no longer hashes to its committed signature")
            if entry.signature != salt + p.raw_signature:
                err("EXEC005", fusion.name,
                    "cache entry signature does not match this compile's options salt + body hash")
        if not p.is_representative:
            continue
        st = entry.stitched
        if st is not None:
            phase_ids = {m.id for ph in st.phases for m in ph.members}
            member_ids = {m.id for m in fusion.members}
            if phase_ids != member_ids:
                err("PLAN005", fusion.name, "stitched phases do not partition the member set "
                                            f"({len(phase_ids)} phase members vs {len(member_ids)} fusion members)")
            for k, ph in enumerate(st.phases):
                diags.extend(_verify_solution(ph.members, ph.solution, ph.blocks,
                                              f"{fusion.name}/phase{k}", pass_name))
            phase_of = {m.id: k for k, ph in enumerate(st.phases) for m in ph.members}
            want = {
                m.id for ph in st.phases for m in ph.members
                if any(phase_of.get(u.id, -1) > phase_of[m.id] for u in m.users)
            }
            got = {i.id for i in st.interfaces}
            if want != got:
                err("PLAN005", fusion.name, "staged interfaces disagree with the phase dataflow "
                                            f"({len(got)} staged, {len(want)} required)")
        elif entry.solution is not None:
            diags.extend(_verify_solution(fusion.members, entry.solution, entry.solution.blocks,
                                          fusion.name, pass_name))
        else:
            err("PLAN005", fusion.name, "planned entry carries neither a schedule solution nor a stitched plan")

        mem = entry.memory
        if mem is not None:
            used = mem.budget_bytes
            if used > opts.vmem_limit:
                err("PLAN006", fusion.name, f"memory plan needs {used}B > budget {opts.vmem_limit}B")
        kernel = p.kernel
        if kernel is not None and kernel.fn.shared_bytes > SMEM_LIMIT:
            err("PLAN006", fusion.name, f"kernel {kernel.fn.name} asks {kernel.fn.shared_bytes}B "
                                        f"of shared memory a block > {SMEM_LIMIT}B")
    return diags


# --------------------------------------------------------------------------
# Family 3: ExecutionPlan lint
# --------------------------------------------------------------------------


def verify_execution_plan(ep, pass_name: str = "") -> List[Diagnostic]:
    """Dataflow over the flat slot table, then the CUDA-graph audit."""
    from .executor import _step_name, _step_outs

    diags: List[Diagnostic] = []

    def err(rule: str, subject: str, message: str) -> None:
        diags.append(Diagnostic(ERROR, rule, message, subject, pass_name))

    param_slots = {slot for _, slot, _, _ in ep._param_binds}
    template_slots = {i for i, v in enumerate(ep._template) if v is not None}
    root_slots = {s for _, s in ep._root_binds}

    written: Set[int] = set(param_slots) | template_slots
    released: Set[int] = set()
    for step in ep.steps:
        name = _step_name(step)
        for s in step.arg_slots:
            if s not in written:
                err("EXEC001", name, f"reads slot {s} before it is written")
            elif s in released:
                err("EXEC002", name, f"reads slot {s} after its release point")
        for s in _step_outs(step):
            if s in written:
                err("EXEC001", name, f"writes slot {s} twice")
            if s in released:
                err("EXEC003", name, f"writes slot {s} after its release")
            written.add(s)
        for s in step.release:
            if s in root_slots:
                err("EXEC003", name, f"releases root slot {s}")
            if s in released:
                err("EXEC003", name, f"releases slot {s} twice")
            if s not in written:
                err("EXEC003", name, f"releases slot {s} that was never written")
            released.add(s)
    for rname, s in ep._root_binds:
        if s not in written:
            err("EXEC001", rname, f"root slot {s} is never produced")

    # -- the CUDA-graph audit (what donation is to the reference) ------------
    protected = param_slots | template_slots
    g = ep._graph
    for step in g.steps:
        for s in _step_outs(step):
            if s in protected:
                err("EXEC004", _step_name(step), f"writes protected slot {s} (parameter/template buffer)")
    for s in g.feed_slots:
        if s in template_slots:
            err("EXEC004", "graph", f"copies template slot {s} into a static input")
    # slots read after each step: by a later step, or as a root
    later: Set[int] = set(root_slots)
    reads_after: List[Set[int]] = []
    for step in reversed(g.steps):
        reads_after.append(set(later))
        later.update(step.arg_slots)
    reads_after.reverse()
    released_at = {s: i for i, step in enumerate(g.steps) for s in step.release}
    for s in g.pool_released:
        if s in protected:
            err("EXEC004", "graph", f"releases protected slot {s} (parameter/template buffer) "
                                    "into the graph's pool")
        i = released_at.get(s)
        if i is None:
            err("EXEC004", "graph", f"releases slot {s} into its pool at no step")
        elif s in reads_after[i] or s in g.out_slots:
            err("EXEC004", "graph", f"releases slot {s} into its pool while it is still read")
    return diags


def verify_shard_attrs(module: Module, mesh_axes, param_layouts=None,
                       pass_name: str = "") -> List[Diagnostic]:
    """Shard-layout lint: re-derive every layout and partial sum from
    scratch and compare with the stamped attrs (PLAN007); flag partial sums
    that reach a root (PLAN008)."""
    from .shard import derive_layouts, is_trivial_layout

    try:
        layouts, partial, _ = derive_layouts(module, mesh_axes, param_layouts)
    except ValueError as e:
        return [Diagnostic(ERROR, "PLAN007", str(e), module.name, pass_name)]

    diags: List[Diagnostic] = []

    def err(rule: str, subject: str, message: str) -> None:
        diags.append(Diagnostic(ERROR, rule, message, subject, pass_name))

    for instr in module.instructions:
        expected = layouts.get(instr.id)
        stamped = instr.attrs.get("shard")
        if expected is not None and not is_trivial_layout(expected):
            if stamped != expected:
                err("PLAN007", instr.name, f"stamped shard {stamped!r} != derived {expected!r}")
        elif stamped is not None:
            err("PLAN007", instr.name,
                f"stale shard stamp {stamped!r} (derived layout is trivial or unknown)")
        want_partial = tuple(sorted(partial.get(instr.id, ())))
        got_partial = tuple(instr.attrs.get("partial", ()))
        if want_partial != got_partial:
            err("PLAN007", instr.name,
                f"stamped partial {got_partial!r} != derived {want_partial!r}")
    for r in module.roots:
        open_axes = tuple(sorted(partial.get(r.id, ())))
        if open_axes:
            err("PLAN008", r.name, f"root carries an open partial sum over axes {open_axes} "
                "— missing all_reduce/reduce_scatter")
    return diags


# --------------------------------------------------------------------------
# Boundary dispatch
# --------------------------------------------------------------------------


def verify_state(state, pass_name: str = "") -> List[Diagnostic]:
    """Every analysis family the state's contents support: the shard lint
    once ShardingPass has stamped, the fusion-plan lint once FusionPass has
    planned, the entry lint once SchedulePass has, the ExecutionPlan lint
    once FinalizePass has built it."""
    diags: List[Diagnostic] = list(verify_module(state.module, pass_name))
    if state.shard_stats and state.options.mesh_axes:
        diags.extend(verify_shard_attrs(state.module, state.options.mesh_axes,
                                        state.param_layouts, pass_name))
    view = _plan_view(state)
    if view is not None:
        fusions, standalone = view
        diags.extend(verify_fusion_groups(fusions, standalone, state.module, pass_name))
    if state.planned:
        diags.extend(verify_planned_entries(state, pass_name))
    ep = getattr(state.executable, "execution_plan", None)
    if ep is not None:
        diags.extend(verify_execution_plan(ep, pass_name))
    return diags


def _plan_view(state) -> Optional[Tuple[list, list]]:
    """The (fusions, standalone) partition as it stands at this boundary."""
    executable = state.executable
    if executable is not None:
        plan = executable.plan
        return list(plan.fusions), list(plan.standalone)
    if state.fusion_plan is None:
        return None
    if state.planned or state.demoted:
        return ([p.fusion for p in state.planned],
                list(state.fusion_plan.standalone) + list(state.demoted))
    return list(state.fusion_plan.fusions), list(state.fusion_plan.standalone)
