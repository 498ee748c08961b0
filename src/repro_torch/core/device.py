"""Where the port runs: the device an entry point targets, and the device a
kernel wrapper's tensors lie on.

Entry points run on the card unless the caller asks for the CPU, and a
missing card is an error, never a silent CPU run.  A kernel wrapper
launches its kernel on CUDA tensors, runs its plain version on CPU
tensors, and refuses any other device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  A missing card is an error, never a silent CPU run."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain kernels"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def input_device(name: str, tensors) -> torch.device:
    """The one device of a kernel wrapper's input tensors: ``cuda`` (the
    kernel) or ``cpu`` (its plain version).  Raises on mixed devices and on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: inputs on {dev}; the kernel runs on cuda and its plain "
            "version on cpu"
        )
    return dev
