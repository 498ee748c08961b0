"""Atomic, resumable checkpointing: the reference's
``repro/checkpoint/manager.py`` over torch tensors, with its layout.

Layout: ``<dir>/step_<n>/`` holds ``params.npz``, ``opt_m.npz`` and
``opt_v.npz`` (one array a leaf, keyed by its path ``/embed/tok``, dict keys
sorted) and ``META`` (JSON: the step and the optimizer's step).  Writes go
to ``.tmp_step_<n>`` and are ``os.replace``d into place, so a partially
written checkpoint is never visible; ``restore_latest`` takes the newest
complete step; the last K are kept.  Arrays are whole host arrays.

numpy has no bfloat16 and the port has no ml_dtypes, so a bf16 leaf is
written by its bits: an array of ``ir.BFLOAT16`` (a 2-byte structured
dtype, one ``<u2`` field named ``bfloat16``).  A 2-byte void array (what an
ml_dtypes bf16 array's ``.npy`` header reads back as) is taken by its bits
the same way.  A checkpoint the reference writes for an f32 config
restores to the same values.

Sharded state (``DTensor`` leaves, the sharded train step's) is saved as
the reference saves a global array: every rank gathers each leaf through
the port's collectives (``shard.gather_dtensor``), rank 0 alone writes (at
once: ``async_save`` applies to unsharded state), and the save returns once
every rank has passed a barrier after the write.  On
restore every rank reads the global arrays and keeps its block of each
(``shard.dtensor_like``), placed as its template is.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.ir import BFLOAT16
from ..train.optimizer import AdamWState


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_host(t) -> np.ndarray:
    """A tensor as a host array: bf16 by its bits (``BFLOAT16``); a
    ``DTensor`` as its global value (a collective of its mesh)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if _is_dtensor(t):
        from ..core.shard import gather_dtensor

        t = gather_dtensor(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16).view(BFLOAT16)
    return t.numpy().copy()


def from_host(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device``; a 2-byte
    structured or void array is bf16 by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = to_host(node)

    walk("", tree)
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, params, opt_state: AdamWState) -> str:
        """Copy the params and state to the host now (the caller may go on
        updating them in place), then write; with ``async_save`` the write
        runs on a thread, joined by the next save or ``wait``."""
        self.wait()
        host_params = _flatten_with_paths(params)
        host_m = _flatten_with_paths(opt_state.m)
        host_v = _flatten_with_paths(opt_state.v)
        sharded = _is_dtensor(opt_state.step)
        host_step = int(opt_state.step.to_local() if sharded else opt_state.step)
        if sharded:
            import torch.distributed as dist

            if dist.get_rank() == 0:
                self._write(step, host_params, host_m, host_v, host_step)
            dist.barrier()
            return os.path.join(self.dir, f"step_{step}")

        args = (step, host_params, host_m, host_v, host_step)
        if self.async_save:
            self._pending = threading.Thread(target=self._write, args=args, daemon=True)
            self._pending.start()
        else:
            self._write(*args)
        return os.path.join(self.dir, f"step_{step}")

    def _write(self, step, host_params, host_m, host_v, host_step):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "params.npz"), **host_params)
        np.savez(os.path.join(tmp, "opt_m.npz"), **host_m)
        np.savez(os.path.join(tmp, "opt_v.npz"), **host_v)
        with open(os.path.join(tmp, "META"), "w") as f:
            json.dump({"step": step, "opt_step": host_step}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "META")
            ):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def restore(self, step: int, like_params, like_opt: AdamWState):
        """(params, opt_state, step) of checkpoint ``step``, each leaf with
        its template's dtype on its template's device."""
        base = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(base, "META")) as f:
            meta = json.load(f)
        with np.load(os.path.join(base, "params.npz")) as npz:
            params = _unflatten_like(like_params, npz)
        with np.load(os.path.join(base, "opt_m.npz")) as npz:
            m = _unflatten_like(like_opt.m, npz)
        with np.load(os.path.join(base, "opt_v.npz")) as npz:
            v = _unflatten_like(like_opt.v, npz)
        opt_step = torch.tensor(meta["opt_step"], dtype=torch.int32, device=like_opt.step.device)
        if _is_dtensor(like_opt.step):
            from ..core.shard import dtensor_like

            opt_step = dtensor_like(opt_step, like_opt.step)
        return params, AdamWState(opt_step, m, v), meta["step"]

    def restore_latest(self, like_params=None, like_opt=None):
        steps = self.available_steps()
        if not steps:
            return None
        if like_params is None:
            # structure-free load requires templates; the Trainer passes them
            raise ValueError("restore_latest needs template trees")
        return self.restore(steps[-1], like_params, like_opt)


def _unflatten_like(template, npz) -> Any:
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            vals = [walk(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(vals) if not hasattr(node, "_fields") else type(node)(*vals)
        if _is_dtensor(node):
            from ..core.shard import dtensor_like

            return dtensor_like(from_host(npz[prefix], node.dtype, node.device), node)
        return from_host(npz[prefix], node.dtype, node.device)

    return walk("", template)
