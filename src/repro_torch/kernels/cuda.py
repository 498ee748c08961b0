"""The hand-written CUDA kernels of ``csrc/`` as Python objects.

A ``CudaSource`` is one ``.cu`` file: ``load`` builds it with
``core/cuda_build`` (nvcc, ``sm_90a``, at first use, into
``build/repro_torch/``) and loads it with ``ctypes``.  A ``HandKernel`` is
one kernel of such a file: the TPU kernel it replaces, and the count of its
launches.  ``launch`` calls one of the file's ``extern "C"`` launchers on
the current CUDA stream and raises on any CUDA error it returns; it never
builds and never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..core import cuda_build


class CudaSource:
    """One hand-written ``.cu`` file under ``csrc/`` and its loaded library."""

    def __init__(self, filename: str):
        self.path = cuda_build.CSRC / filename
        self.lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        """Build (once per checkout) and load the library; raises if nvcc is
        missing or the build fails."""
        if self.lib is None:
            self.lib, _ = cuda_build.load(self.path.read_text())
        return self.lib


def _ctype(arg):
    if isinstance(arg, torch.Tensor):
        return ctypes.c_void_p
    if isinstance(arg, int):
        return ctypes.c_int
    if isinstance(arg, float):
        return ctypes.c_float
    raise TypeError(f"no C type for {type(arg).__name__}")


class HandKernel:
    """One hand-written kernel: ``name``, the ``CudaSource`` that holds it,
    the TPU kernel it ``replaces`` (file:line of its ``pallas_call``), and
    ``launches``, which counts kernel launches and nothing else, in all and
    by launcher (``by_symbol``)."""

    def __init__(self, name: str, source: CudaSource, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.by_symbol: Dict[str, int] = {}

    def launch(self, symbol: str, *args, device: torch.device) -> None:
        """Call the launcher ``symbol`` with ``args`` (tensors pass their
        data pointers, ints and floats their C values) and the current
        stream of ``device``."""
        lib = self.source.lib
        if lib is None:
            raise RuntimeError(
                f"{self.name}: no CUDA library is loaded for this kernel "
                f"(load() builds {self.source.path.name})"
            )
        if device.index not in (None, torch.cuda.current_device()):
            # the launcher runs in the current device's context
            raise ValueError(f"{self.name}: inputs on {device}, not the current device")
        fn = getattr(lib, symbol)
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = fn(*values, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {symbol} failed with cudaError {rc}")
        self.launches += 1
        self.by_symbol[symbol] = self.by_symbol.get(symbol, 0) + 1


ROWWISE = CudaSource("stitched_rowwise.cu")
ATTENTION = CudaSource("stitched_attention.cu")
SOURCES = (ROWWISE, ATTENTION)

#: the dtypes every kernel takes, and the suffix of their launchers
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def check_tensor(kernel: str, what: str, t: torch.Tensor, dtypes=tuple(DTYPE_SUFFIX)) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor of one of
    ``dtypes``: what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{kernel}: {what} is a {type(t).__name__}, not a tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{kernel}: {what} is {t.dtype}; the kernel takes {list(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} is not contiguous")
