"""Gradient compression: int8 ring all-reduce with error feedback (the
reference's ``repro.optim.compression``).

Each call:
  1. adds the error-feedback residual to the local gradient,
  2. quantizes to int8 with one f32 scale per block of ``BLOCK`` values,
  3. ring all-reduces over a ``torch.distributed`` process group: every hop
     sends the int8 blocks and scales one rank to the right and adds the
     dequantized blocks from the left, in the reference's ``lax.ppermute``
     ring order,
  4. keeps the quantization error as the next call's residual.
The group is gloo on the CPU, NCCL on the card; without an initialised
process group the ring has one member.

The reference's hop ``acc + dequantize(q, s)`` compiles (XLA on the CPU)
to one fused multiply-add: ``acc + q * s`` rounded once. The port adds in
f64, where ``q * s`` (int8 times f32) is exact, and rounds the sum to f32
once, so the sums equal the reference's bit for bit on the test inputs; a
sum that f64 cannot hold exactly (addends more than 2^20 apart in scale)
could round twice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 2048  # quantization block (per-block scale)


def _blocked(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), pad


def quantize(x: torch.Tensor):
    """x: (..., B). Returns int8 values and f32 per-row scales."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _unblock(flat: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = flat.reshape(-1)
    return (flat[:-pad] if pad else flat).reshape(shape)


def quantized_psum(x: torch.Tensor, group=None, residual=None):
    """Quantized ring all-reduce of ``x`` over ``group`` (the default group
    when None). Returns (sum over the ranks, new error-feedback residual).
    The sum is of the quantized contributions; each rank's quantization
    error stays local in the residual and is re-injected next call."""
    ring = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size(group) if ring else 1
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual
    blocks, pad = _blocked(xf)
    q, s = quantize(blocks)
    err = _unblock(blocks - dequantize(q, s), pad, x.shape)

    acc = dequantize(q, s)
    if n > 1:
        rank = dist.get_rank(group)
        right, left = (rank + 1) % n, (rank - 1) % n
        if group is not None:
            right = dist.get_global_rank(group, right)
            left = dist.get_global_rank(group, left)
        for _ in range(n - 1):
            q_in, s_in = torch.empty_like(q), torch.empty_like(s)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, q, right, group),
                dist.P2POp(dist.isend, s, right, group),
                dist.P2POp(dist.irecv, q_in, left, group),
                dist.P2POp(dist.irecv, s_in, left, group)])
            for r in reqs:
                r.wait()
            q, s = q_in, s_in
            acc = (acc.double() + q.double() * s.double()).float()
    return _unblock(acc, pad, x.shape), err
