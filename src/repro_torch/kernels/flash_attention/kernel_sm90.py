"""Build and launch of the bf16 flash attention kernel for Hopper.

The source is ``csrc/flash_attention_sm90.cu`` (design and bounds are in
its header): wgmma on the tensor cores, fed by TMA, with a producer
warpgroup and three consumer warpgroups at head dim 64 (two at 128; at 240
two and no producer, the consumers reloading the ring, so that they keep up
to 255 registers), P split into two bf16 parts so that P V keeps f32
accuracy; at 16 and 32, where the exponentials bound it, four consumer
warpgroups and no producer (they reload the ring themselves) and boxes
exactly D wide with the 32- or 64-byte swizzle. It replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py::_flash_kernel`` for bf16
inputs at every head dim the port takes (``kernel_tf32.py`` takes float32
ones). It is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` on first use (or by :func:`build`) and loaded with
``ctypes``, both through :mod:`repro_torch.kernels.nvcc_build`. The checked
entry point with the launch counts is
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..nvcc_build import build_library, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_sm90.cu"
HEAD_DIMS = (16, 32, 64, 128, 240)  # the .cu's template instances
# keys per KV tile of each instance (the .cu's Shape<D>::BK): 64 at D = 240,
# where S and P of 128 keys beside O would spill past 240 registers
BLOCK_K = {16: 128, 32: 128, 64: 128, 128: 128, 240: 64}
BLOCK_Q = 128                       # fewest query rows per CTA
MAX_QUERY_TILES = 65535             # grid.y
ERR_TENSOR_MAP = 10000              # + the CUresult of a refused tensor map

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/flash_attention_sm90.cu`` (skipped when the library
    for this exact source is already built) and return the library's
    path."""
    return build_library(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        fn = lib.flash_attention_sm90_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out, D, B, H, K, Sq, Sk, strides, scale * log2(e), causal,
        # stream
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P, ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, scale: float) -> None:
    """Launch on tensors the caller has checked: q (B, Sq, H, D), k/v
    (B, Sk, K, D) bf16 with D in :data:`HEAD_DIMS`, out (B, Sq, H, D) f32,
    all on one CUDA device, last dimension contiguous, strides a multiple of
    8 elements and 16-byte-aligned bases, ``scale >= 0``."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _load().flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), D, B,
            H, K, Sq, Sk, ctypes.cast(strides, ctypes.c_void_p),
            float(scale) * math.log2(math.e), int(causal), stream)
    if err >= ERR_TENSOR_MAP:
        raise RuntimeError(f"flash_attention (wgmma): cuTensorMapEncodeTiled "
                           f"refused a tensor map (CUresult "
                           f"{err - ERR_TENSOR_MAP})")
    if err != 0:
        raise RuntimeError(f"flash_attention (wgmma): CUDA launch failed "
                           f"with error {err}")


def instance_name(D: int) -> str:
    """The mangled-name fragment of the kernel instance a launch at head dim
    ``D`` runs (for reading ptxas's report)."""
    return f"flash_sm90_kernelILi{D}EE"
