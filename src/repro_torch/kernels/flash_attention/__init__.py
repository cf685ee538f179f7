"""Flash attention: CUDA kernels (``ops.flash_attention``: wgmma for bf16 and
3xTF32 wgmma for float32, each at head dims 16, 32, 64, 128 and 240;
``ops.route`` says which) and their plain versions (``ref.attention_ref``;
``ref.attention_bf16p_model`` and ``ref.attention_3xtf32_model`` model the
two tensor-core kernels' arithmetic)."""
from .ops import flash_attention, route
from .ref import (attention_ref, attention_bf16p_model,
                  attention_3xtf32_model)

__all__ = ["flash_attention", "route", "attention_ref",
           "attention_bf16p_model", "attention_3xtf32_model"]
