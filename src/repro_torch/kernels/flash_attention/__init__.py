"""Flash attention: CUDA kernel (``ops.flash_attention``) and its plain
version (``ref.attention_ref``)."""
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
