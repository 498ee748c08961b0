"""Performance library — paper §4.4, adapted for TPU.

The paper keeps a persistent key-value store mapping
``(opcode, shape, split_dim, sword, sched_type, block size, ...)`` to
measured kernel microseconds; on a miss it compiles a CUDA micro-kernel and
``nvprof``s it.  This container has no TPU to profile, so we keep the
**storage and lookup protocol intact** (persistent JSON KV with the same key
features) but replace the miss handler with the shared analytic
``LatencyModel`` (``core/latency.py``) — the substitution the paper itself
anticipates in §4.4 ("build a learning model to predict a performance metric
from features in the key").  On real hardware the miss handler would compile
the schedule into a Pallas micro-kernel and time it; the interface is
identical.

The hardware constants and roofline math used to live here; they moved to
``core/latency.py`` so the fusion planner, the tuner, and the launch-time
roofline table score against ONE device spec.  ``TpuSpec`` and ``CostModel``
remain as aliases for existing callers.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

from .ir import Instruction
from .latency import (  # noqa: F401 — compatibility re-exports
    TPU_V5E,
    DeviceSpec,
    LatencyModel,
    instr_flops,
)
from .schedule import Sched

# Backwards-compatible names: the device spec and the per-op roofline model
# are now defined once in core/latency.py.
TpuSpec = DeviceSpec
CostModel = LatencyModel


class JsonStore:
    """Tiny persistent JSON KV store with atomic save — the paper's §4.4
    storage protocol, shared by PerfLibrary and the kernel cache."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._store: Dict[str, object] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._store = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._store = {}

    def get(self, key: str, default=None):
        with self._lock:
            return self._store.get(key, default)

    def put(self, key: str, value) -> None:
        with self._lock:
            self._store[key] = value

    def pop(self, key: str, default=None):
        with self._lock:
            return self._store.pop(key, default)

    def save(self) -> None:
        """Atomically persist the store.

        The payload is fully written (and fsync'd) to a *uniquely named*
        temp file in the target directory, then ``os.replace``d over the
        destination.  A crash mid-write — or a concurrent saver from another
        process — can therefore never leave a truncated or interleaved JSON
        file at ``self.path``: readers see either the old complete store or
        the new complete store.  (A fixed ``path + ".tmp"`` scratch name is
        NOT safe: two processes would interleave writes into the same temp
        file and then replace the real store with the torn result.)
        """
        if not self.path:
            return
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self.path) + ".", suffix=".tmp",
            dir=directory,
        )
        try:
            with self._lock:
                with os.fdopen(fd, "w") as f:
                    json.dump(self._store, f)
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            # the destination is untouched; drop our scratch file
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def __len__(self):
        return len(self._store)


class PerfLibrary(JsonStore):
    """Persistent KV store of per-op schedule timings (paper §4.4).  Its
    model's spec is the device the timings describe: keys under any spec
    other than ``TPU_V5E`` carry the spec's fingerprint, so one file never
    serves two devices."""

    def __init__(self, path: Optional[str] = None, model: Optional[LatencyModel] = None):
        super().__init__(path)
        self.model = model or LatencyModel()
        spec = self.model.spec
        self._salt = "" if spec == TPU_V5E else f"{spec.fingerprint()}|"
        self.hits = 0
        self.misses = 0

    def key(self, instr: Instruction, sched: Sched, launch_blocks: int) -> str:
        feats = (
            instr.opcode,
            instr.attrs.get("fn", instr.attrs.get("kind", "")),
            tuple(instr.shape),
            str(np.dtype(instr.dtype)),
            sched.kind,
            sched.split_dim,
            sched.sword,
            sched.sched_type,
            launch_blocks,
        )
        return self._salt + repr(feats)

    def lookup(self, instr: Instruction, sched: Sched, launch_blocks: int) -> float:
        k = self.key(instr, sched, launch_blocks)
        with self._lock:
            if k in self._store:
                self.hits += 1
                return self._store[k]
        t = self.model.op_time(instr, sched, launch_blocks)
        with self._lock:
            self.misses += 1
            self._store[k] = t
        return t
