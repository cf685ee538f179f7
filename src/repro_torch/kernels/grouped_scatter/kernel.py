"""CUDA kernel for the group-locking segment reduction, and its wrapper.

``segment_sums`` replaces the Pallas TPU kernel
``repro/kernels/grouped_scatter/kernel.py::_seg_matmul_kernel``. The source
is ``csrc/segment_sums.cu`` (design and bound are in its header). It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout on first use (or by :func:`build`), and loaded with ``ctypes``
(both through :mod:`repro_torch.kernels.nvcc_build`).

The wrapper launches the kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it runs the plain version
(:func:`segment_sums_ref`). ``segment_sums.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ...device import refuse_dtensors
from ..nvcc_build import build_library, load_library
from .ref import segment_sums_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sums.cu"
BD = 128                  # reduce: columns per block (must match the .cu)
BLOCKS_PER_SM = 8         # reduce blocks resident per SM (1024 threads)
MIN_ROWS_PER_BLOCK = 256  # sorted positions per reduce block, at least
SORT_CHUNK_MIN = 2048     # rows per counting-sort chunk, at least
SORT_CHUNKS_MAX = 128     # counting-sort chunks (one warp each), at most
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may use

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/segment_sums.cu`` (skipped when the library for this
    exact source is already built) and return the library's path."""
    return build_library(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        fn = lib.segment_sums_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # seg, upd, out, N, D, G, is_half, counts, n_chunks, chunk, gstart,
        # perm, sg, head, tail, n_blocks, rb, stream
        fn.argtypes = [P, P, P, LL, I, I, I, P, I, LL, P, P, P, P, P, I, LL,
                       P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_plan(N: int, D: int, n_sms: int) -> tuple[int, int, int, int]:
    """(n_chunks, chunk, n_blocks, rb): the counting sort walks ``n_chunks``
    chunks of ``chunk`` rows; the reduce splits the sorted positions into
    ``n_blocks`` blocks of ``rb``, enough to keep ``BLOCKS_PER_SM`` blocks
    on every SM across the ``ceil(D / BD)`` column tiles."""
    n_chunks = max(1, min(SORT_CHUNKS_MAX, math.ceil(N / SORT_CHUNK_MIN)))
    chunk = max(1, math.ceil(N / n_chunks))
    per_tile = math.ceil(n_sms * BLOCKS_PER_SM / math.ceil(D / BD))
    n_blocks = max(1, min(math.ceil(N / MIN_ROWS_PER_BLOCK), per_tile))
    rb = max(1, math.ceil(N / n_blocks))
    return n_chunks, chunk, n_blocks, rb


def segment_sums(seg_ids: torch.Tensor, updates: torch.Tensor,
                 num_groups: int) -> torch.Tensor:
    """Per-group sums: seg_ids (N,) i32, updates (N, D) f32 or f16 ->
    (num_groups, D) f32. Ids outside [0, num_groups) are dropped; ids may
    come in any order. The kernel has no backward pass: an ``updates`` that
    requires grad raises under grad mode, on every device, and so does a
    DTensor (pass each rank's local shard)."""
    refuse_dtensors("segment_sums", seg_ids, updates)
    if torch.is_grad_enabled() and updates.requires_grad:
        raise RuntimeError("segment_sums: the kernel has no backward pass; "
                           "call it on updates that do not require grad, "
                           "or under torch.no_grad()")
    if seg_ids.device.type == "cpu" and updates.device.type == "cpu":
        return segment_sums_ref(seg_ids, updates, num_groups)
    if seg_ids.device.type != "cuda" or updates.device != seg_ids.device:
        raise ValueError("segment_sums: seg_ids and updates must lie on one "
                         f"CUDA device, got {seg_ids.device} and "
                         f"{updates.device}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_sums: seg_ids must be int32, got "
                        f"{seg_ids.dtype}")
    if updates.dtype not in (torch.float32, torch.float16):
        raise TypeError(f"segment_sums: updates must be float32 or float16, "
                        f"got {updates.dtype}")
    if seg_ids.dim() != 1 or updates.dim() != 2 \
            or updates.shape[0] != seg_ids.shape[0]:
        raise ValueError(f"segment_sums: need seg_ids (N,) and updates "
                         f"(N, D), got {tuple(seg_ids.shape)} and "
                         f"{tuple(updates.shape)}")
    if not (seg_ids.is_contiguous() and updates.is_contiguous()):
        raise ValueError("segment_sums: inputs must be contiguous")
    N, D = updates.shape
    G = int(num_groups)
    if G < 0 or N >= 2**31 or G * D >= 2**31 or G * 4 > SMEM_MAX:
        raise ValueError(f"segment_sums: unsupported sizes N={N} G={G} "
                         f"D={D}")
    dev = updates.device
    out = torch.empty((G, D), dtype=torch.float32, device=dev)
    if G == 0 or D == 0:
        return out.zero_()
    n_chunks, chunk, n_blocks, rb = launch_plan(
        N, D, torch.cuda.get_device_properties(dev).multi_processor_count)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    counts, gstart, perm, sg = i32(n_chunks, G), i32(G + 1), i32(N), i32(N)
    head = torch.empty((n_blocks, D), dtype=torch.float64, device=dev)
    tail = torch.empty_like(head)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _load().segment_sums_launch(
            seg_ids.data_ptr(), updates.data_ptr(), out.data_ptr(), N, D, G,
            int(updates.dtype == torch.float16), counts.data_ptr(), n_chunks,
            chunk, gstart.data_ptr(), perm.data_ptr(), sg.data_ptr(),
            head.data_ptr(), tail.data_ptr(), n_blocks, rb, stream)
    if err != 0:
        raise RuntimeError(f"segment_sums: CUDA launch failed with error "
                           f"{err}")
    segment_sums.launches += 1
    return out


segment_sums.launches = 0
