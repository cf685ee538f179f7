"""Device resolution for the port's entry points.

Every public entry point takes ``device=None`` and resolves it here: None
means the CUDA card, and a missing card is an error rather than a silent
CPU run. The CPU runs only when a caller names it (``device="cpu"``), as
the tests do.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when the requested CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU explicitly")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (a tensor
    placed on a device mesh)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def refuse_dtensors(name: str, *tensors) -> None:
    """A kernel wrapper's guard: its kernel reads one device's memory, so a
    DTensor raises rather than being gathered behind the caller's back."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; the kernel takes tensors on "
                        f"one device: pass each rank's local shard "
                        f"(DTensor.to_local()) and wrap the result "
                        f"(DTensor.from_local())")
