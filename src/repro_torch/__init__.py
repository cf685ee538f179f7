"""PyTorch + CUDA port of ``repro`` (TXSQL lock optimisations).

The package mirrors ``repro``'s layout and imports neither JAX nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).

Ported: the lock engine with its batched and segmented entries
(``core.lock``), the sweep, governor, serving layer, tracer and certifier
(``sweep``, ``adaptive``, ``serving``, ``obs``, ``analysis``), the paper's
technique on tensors (``core``) with the ``segment_sums`` CUDA kernel
(``kernels.grouped_scatter``), the model stack with the flash attention
kernels (``configs``, ``models``, ``kernels.flash_attention``), and its
training half: the loss, AdamW and gradient compression (``optim``), the
data pipeline (``data``), checkpointing (``checkpoint``), failure,
straggler and sharding planning (``distributed``) and the train driver
(``launch.train``).
"""
