"""Build and launch of the flash attention CUDA kernel.

The source is ``csrc/flash_attention.cu`` (design and bound are in its
header). It replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It is compiled
with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` on first use (or by
:func:`build`) and loaded with ``ctypes``, both through
:mod:`repro_torch.kernels.nvcc_build`. The checked entry point with the
launch count is :func:`repro_torch.kernels.flash_attention.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..nvcc_build import build_library, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 240)  # the .cu's template instances
DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/flash_attention.cu`` (skipped when the library for
    this exact source is already built) and return the library's path."""
    return build_library(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        fn = lib.flash_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out, is_bf16, D, B, H, K, Sq, Sk, strides, scale, causal,
        # stream
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P, ctypes.c_float, I,
                       P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, scale: float) -> None:
    """Launch on tensors the caller has checked: q (B, Sq, H, D), k/v
    (B, Sk, K, D) of one dtype in :data:`DTYPES`, out (B, Sq, H, D) f32, all
    on one CUDA device, last dimension contiguous, strides a multiple of 4
    elements and 16-byte-aligned bases."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), D, B, H, K, Sq, Sk,
            ctypes.cast(strides, ctypes.c_void_p), float(scale), int(causal),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error "
                           f"{err}")
