"""PyTorch + CUDA port of ``repro`` (TXSQL lock optimisations).

The package mirrors ``repro``'s layout and imports neither JAX nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).

Ported so far: the lock engine's single-lane ``simulate()`` path
(``core.lock``), the paper's technique on tensors (``core.hotspot``,
``core.group_apply``, ``core.dependency``) and the group-locking
``segment_sums`` CUDA kernel (``kernels.grouped_scatter``).
"""
