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
