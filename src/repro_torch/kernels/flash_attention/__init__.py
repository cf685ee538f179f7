"""Flash attention: CUDA kernels (``ops.flash_attention``: wgmma for bf16 at
head dims 64, 128 and 240, float32 FMA otherwise; ``ops.route`` says which) and
their plain versions (``ref.attention_ref``; ``ref.attention_bf16p_model``
models the wgmma kernel's arithmetic)."""
from .ops import flash_attention, route
from .ref import attention_ref, attention_bf16p_model

__all__ = ["flash_attention", "route", "attention_ref",
           "attention_bf16p_model"]
