"""Build and launch of the float32 flash attention kernel on the tensor cores.

The source is ``csrc/flash_attention_tf32.cu`` (design and bounds are in its
header): a prep kernel splits k and v into TF32 hi and lo parts (V
transposed, keys contiguous), then wgmma ``.tf32`` computes each product as
hi.hi + hi.lo + lo.hi (3xTF32), fed by TMA, two consumer warpgroups of 64
query rows and no producer warpgroup (at D = 240 Q waits in f32, in shared
memory and registers, and is split per k-step, and P V runs in thirds of
O's columns). It replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel`` for float32
inputs at head dims 16, 32, 64, 128 and 240. It is compiled with ``nvcc``
for ``sm_90a`` into
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_tf32.cu"
HEAD_DIMS = (16, 32, 64, 128, 240)  # the .cu's template instances
# keys per KV tile of each instance (the .cu's Shape<D>::BK): 32 at D = 128,
# where Q's hi and lo parts take 128 registers a thread, and at D = 240,
# where a K and a V^T tile of 32 keys (126,976 B) fit beside Q's f32 only
# with 5 of its 30 k-steps in registers
BLOCK_K = {16: 64, 32: 64, 64: 64, 128: 32, 240: 32}
PREP_KEYS = 32                      # keys a block of the prep kernel writes
BLOCK_Q = 128                       # query rows per CTA
MAX_QUERY_TILES = 65535             # grid.y
ERR_TENSOR_MAP = 10000              # + the CUresult of a refused tensor map

_libs: dict = {}


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/flash_attention_tf32.cu`` (skipped when the library
    for this exact source is already built) and return the library's
    path."""
    return build_library(SOURCE, verbose)


def load(source: Path = SOURCE) -> ctypes.CDLL:
    """The library built from ``source`` (by default the shipped .cu; the
    variants of ``tools/flash_tf32_variants.py`` pass their own copies)
    with its entry points' argument types set."""
    lib = _libs.get(source)
    if lib is None:
        lib = load_library(source)
        P, I = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out, scratch, D, B, H, K, Sq, Sk, strides,
        # scale * log2(e), causal, stream
        lib.flash_attention_tf32_launch.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I, P, ctypes.c_float, I, P]
        lib.flash_attention_tf32_launch.restype = ctypes.c_int
        # k, v, scratch, D, B, K, Sk, strides, stream
        lib.flash_attention_tf32_prep.argtypes = [P, P, P, I, I, I, I, P, P]
        lib.flash_attention_tf32_prep.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def padded(D: int, Sk: int, block_k: int | None = None) -> tuple[int, int]:
    """(Skp, DP) of the prep's layout: Sk padded to the key tile
    (``block_k``, by default :data:`BLOCK_K`) and to the prep's
    :data:`PREP_KEYS`, and D rounded up to 32 floats (whole 128-byte rows of
    a swizzled box: 256 at D = 240)."""
    pad = max(block_k or BLOCK_K[D], PREP_KEYS)
    return -(-Sk // pad) * pad, -(-D // 32) * 32


def scratch_shapes(D: int, B: int, K: int, Sk: int) -> tuple[tuple, tuple]:
    """Shapes of the prep kernel's outputs, each stored as a hi and a lo
    part one after the other: K's (2, B*K, Skp, DP) and V^T's
    (2, B*K, D, Skp), with (Skp, DP) as :func:`padded` gives them."""
    skp, dp = padded(D, Sk)
    return (2, B * K, skp, dp), (2, B * K, D, skp)


def _scratch(D, B, K, Sk, device) -> torch.Tensor:
    ks, vs = scratch_shapes(D, B, K, Sk)
    return torch.empty(math.prod(ks) + math.prod(vs), dtype=torch.float32,
                       device=device)


def _check(err: int) -> None:
    if err >= ERR_TENSOR_MAP:
        raise RuntimeError(f"flash_attention (tf32x3): cuTensorMapEncodeTiled "
                           f"refused a tensor map (CUresult "
                           f"{err - ERR_TENSOR_MAP})")
    if err != 0:
        raise RuntimeError(f"flash_attention (tf32x3): CUDA launch failed "
                           f"with error {err}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, scale: float,
           lib: ctypes.CDLL | None = None) -> None:
    """Launch the prep and attention kernels on tensors the caller has
    checked: q (B, Sq, H, D), k/v (B, Sk, K, D) float32 with D in
    :data:`HEAD_DIMS`, out (B, Sq, H, D) f32, all on one CUDA device, last
    dimension contiguous, strides a multiple of 4 elements and 16-byte-
    aligned bases. ``lib`` is :func:`load`'s library (by default the
    shipped one)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scratch = _scratch(D, B, K, Sk, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = (lib or load()).flash_attention_tf32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), D, B, H, K, Sq, Sk,
            ctypes.cast(strides, ctypes.c_void_p),
            float(scale) * math.log2(math.e), int(causal), stream)
    _check(err)


def prep(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The prep kernel alone on CUDA k and v (B, Sk, K, D) float32: returns
    K_hi, K_lo (B*K, Skp, DP) and V^T_hi, V^T_lo (B*K, D, Skp), the layout
    ``ref.tf32x3_layout`` computes in plain PyTorch."""
    B, Sk, K, D = k.shape
    ks, vs = scratch_shapes(D, B, K, Sk)
    scratch = _scratch(D, B, K, Sk, k.device)
    strides = (ctypes.c_longlong * 12)(
        0, 0, 0, *k.stride()[:3], *v.stride()[:3], 0, 0, 0)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = load().flash_attention_tf32_prep(
            k.data_ptr(), v.data_ptr(), scratch.data_ptr(), D, B, K, Sk,
            ctypes.cast(strides, ctypes.c_void_p), stream)
    _check(err)
    kt = scratch[:math.prod(ks)].view(ks)
    vt = scratch[math.prod(ks):].view(vs)
    return kt[0], kt[1], vt[0], vt[1]


def instance_name(D: int) -> str:
    """The mangled-name fragment of the attention kernel instance a launch
    at head dim ``D`` runs (for reading ptxas's report)."""
    return f"flash_tf32_kernelILi{D}EE"
