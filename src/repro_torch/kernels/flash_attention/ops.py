"""(B, S, H, D)-layout entry point of the flash attention kernels.

``flash_attention`` launches a CUDA kernel for CUDA tensors (every kernel
reads and writes this layout through strides; the tf32x3 route's prep
kernel writes a transposed copy of V into scratch) and
counts launches in ``flash_attention.launches`` and, by route, in
``flash_attention.launches_by_route``. :func:`route` chooses the kernel. For
CPU tensors it runs the plain version (:func:`attention_ref`). Anything else
raises before a launch: a build or launch failure is an error, never a
fallback. The kernels compute the forward pass only, so a call that autograd
would record (grad mode on and an input that requires grad) raises on every
device: on the card the result would carry no gradient. A DTensor raises
too: the caller passes each rank's local shard (the model's tensor-parallel
path, :func:`repro_torch.models.attention.heads_local`).
"""
from __future__ import annotations

import torch

from ...device import refuse_dtensors, resolve
from . import kernel_sm90, kernel_tf32
from .ref import attention_ref

# route -> the kernel's module, by the dtype it takes
KERNELS = {"wgmma": kernel_sm90, "tf32x3": kernel_tf32}
ROUTES = tuple(KERNELS)
DTYPES = (torch.bfloat16, torch.float32)
# the head dims both kernels have an instance for
HEAD_DIMS = tuple(d for d in kernel_sm90.HEAD_DIMS
                  if d in kernel_tf32.HEAD_DIMS)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call of :func:`flash_attention` takes, by dtype, at
    every head dim of :data:`HEAD_DIMS` (16, 32, 64, 128 and 240):

    * ``"wgmma"`` (``csrc/flash_attention_sm90.cu``, bf16 tensor cores fed
      by TMA, P split into two bf16 parts) for bf16 q, k and v;
    * ``"tf32x3"`` (``csrc/flash_attention_tf32.cu``, float32 on the tensor
      cores as three TF32 products, fed by TMA) for float32 inputs, held to
      the reference's 2e-6.

    Raises ``TypeError`` for any other dtype.
    """
    if q.dtype == torch.bfloat16:
        return "wgmma"
    if q.dtype == torch.float32:
        return "tf32x3"
    raise TypeError(f"flash_attention: no kernel takes {q.dtype} (dtypes "
                    f"{DTYPES})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it, else an aligned contiguous
    copy: last dimension contiguous, 16-byte-aligned base and every other
    stride a multiple of 16 bytes (4 float32 or 8 bf16 elements: what a TMA
    tensor map and the tf32x3 prep kernel's vector loads take)."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernels take these shapes: q
    (B, Sq, H, D), k and v (B, Sk, K, D) with D one of :data:`HEAD_DIMS`,
    H a multiple of K and Sk > 0."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: need q (B, Sq, H, D) and k/v "
                         f"(B, Sk, K, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or K == 0 or H % K or Sk == 0 \
            or max(B, H) > 65535 or max(Sq, Sk) >= 2**31:
        raise ValueError(f"flash_attention: unsupported sizes B={B} Sq={Sq} "
                         f"Sk={Sk} H={H} K={K} D={D} (D in "
                         f"{HEAD_DIMS}, H % K == 0, Sk > 0)")


def checked_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of a kernel call on q, k and v after every check that does
    not need the card (shapes, dtypes, the tile count): raises
    ``TypeError`` or ``ValueError`` where a kernel would not take the call.
    Every route takes any scale (the wgmma kernel's negative one through
    :func:`wgmma_operands`)."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share a dtype in "
                        f"{DTYPES}, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    check_shapes(q, k, v)
    Sq = q.shape[1]
    path = route(q, k, v)
    tiled = KERNELS[path]
    if -(-Sq // tiled.BLOCK_Q) > tiled.MAX_QUERY_TILES:
        raise ValueError(f"flash_attention: the {path} kernel takes at most "
                         f"{tiled.MAX_QUERY_TILES} query tiles of "
                         f"{tiled.BLOCK_Q}, got Sq={Sq}")
    return path


def wgmma_operands(k: torch.Tensor, scale: float):
    """``(k, scale)`` as the wgmma kernel takes them: the kernel folds the
    scale into one FFMA and takes the max of the raw scores, so it needs
    ``scale >= 0``, and a negative scale becomes ``(-k, -scale)``. Exact:
    negating a value is exact, and q.(-k).|s| rounds as q.k.s at every
    step (a sign flip commutes with each rounding)."""
    return (k, scale) if scale >= 0 else (-k, -scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D). Returns (B, Sq, H, D) f32.
    Causal masking is aligned bottom-right (row i sees keys
    j <= i + Sk - Sq), as the reference's ``attention_ref``."""
    refuse_dtensors("flash_attention", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernels have no backward "
                           "pass; call it on inputs that do not require "
                           "grad, or under torch.no_grad()")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal, scale)
    resolve(None)               # the kernel runs on the card: raise without
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {q.device}, {k.device} and {v.device}")
    path = checked_route(q, k, v)
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    if path == "wgmma":
        k, scale = wgmma_operands(k, scale)
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    KERNELS[path].launch(_aligned(q), _aligned(k), _aligned(v), out, causal,
                         scale)
    flash_attention.launches += 1
    flash_attention.launches_by_route[path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
