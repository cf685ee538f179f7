"""Roofline terms of a step on NVIDIA H100 cards (the reference's
``repro.launch.roofline``, which models a TPU v5e-like chip).

Card model (:data:`CARDS`, per card, from NVIDIA's H100 Tensor Core GPU
data sheet; dense rates, i.e. half the data sheet's with-sparsity figures):

    part        HBM        bf16 dense    TF32 dense    f32 (no TC)   NVLink
    H100 SXM    3.35 TB/s  989 TFLOP/s   494.7 TFLOP/s 67 TFLOP/s    900 GB/s
    H100 NVL    3.9 TB/s   835 TFLOP/s   417.5 TFLOP/s 60 TFLOP/s    600 GB/s
    H100 PCIe   2.0 TB/s   756 TFLOP/s   378 TFLOP/s   51 TFLOP/s    600 GB/s

The data sheet's NVLink figure is the total of both directions; the model
takes half of it, the bytes a second each way.

Terms (seconds, per step, per card):
    compute    = flops / PEAK
    memory     = bytes / HBM_BW
    collective = collective_bytes / NVLINK_BW

``flops`` and ``bytes`` are per card. The reference reads them from XLA's
cost analysis and parses collective bytes from the optimized HLO text; the
port has neither, so :func:`analytic_hbm_bytes` and
:func:`model_flops_estimate` give the first two and
:class:`CollectiveCounter` counts the collectives a sharded step really
issues: the operand bytes of every ``_c10d_functional`` collective that
DTensor dispatches while it is installed (as
``torch.distributed.tensor.debug.CommDebugMode`` does). The reference's
HLO-text helpers ``_shape_bytes`` and ``_trip_count`` have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class Card:
    name: str
    hbm_bw: float           # bytes/s
    f32_flops: float        # FLOP/s on the CUDA cores (no tensor cores)
    bf16_flops: float       # dense bf16 tensor-core FLOP/s
    tf32_flops: float       # dense TF32 tensor-core FLOP/s
    nvlink_bw: float        # bytes/s each way


# keyed by a substring of torch.cuda.get_device_name(); the SXM part last,
# as the fallback of :func:`card` ("H100" is in every name)
CARDS = {
    "H100 PCIe": Card("H100 PCIe", 2.0e12, 51e12, 756e12, 378e12, 300e9),
    "H100 NVL": Card("H100 NVL", 3.9e12, 60e12, 835e12, 417.5e12, 300e9),
    "H100": Card("H100 SXM", 3.35e12, 67e12, 989e12, 494.7e12, 450e9),
}


def card(name: str = "") -> Card:
    """The card whose key is in ``name`` (a CUDA device name); the SXM part
    when none is."""
    for key, c in CARDS.items():
        if key in name:
            return c
    return CARDS["H100"]


PEAK_FLOPS = CARDS["H100"].bf16_flops      # bf16 / card
HBM_BW = CARDS["H100"].hbm_bw              # bytes/s / card
NVLINK_BW = CARDS["H100"].nvlink_bw        # bytes/s / card, each way

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op -> the reference's collective name
_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """While installed, counts the operand bytes of every collective this
    rank issues through ``torch.ops._c10d_functional`` (DTensor's
    redistributions, functional collectives), per the reference's
    collective names. ``per_op`` is the reference's ``collective_bytes``
    dict; ``calls`` counts the collectives."""

    def __init__(self):
        super().__init__()
        self.per_op: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.calls: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: it desugars the op into local ops and
            # the collectives it needs, which then come through here
            return NotImplemented
        ns = getattr(func, "namespace", "")
        name = _FUNCOL.get(func._opname) if ns == "_c10d_functional" \
            else None
        if name is not None:
            self.per_op[name] += _nbytes(args[0])
            self.calls[name] += 1
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.per_op.values())


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per-card flops
    bytes_accessed: float        # per-card HBM bytes
    coll_bytes: float            # per-card collective bytes
    coll_breakdown: Dict[str, int]
    model_flops: float           # 6*N*D useful flops (global)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW

    @classmethod
    def on(cls, c: Card, compute: str = "bf16", **fields) -> "Roofline":
        """A roofline at card ``c``'s HBM and NVLink rates and its peak for
        ``compute``: "bf16" or "tf32" on the tensor cores, "f32" on the
        CUDA cores."""
        peak = {"bf16": c.bf16_flops, "tf32": c.tf32_flops,
                "f32": c.f32_flops}[compute]
        return cls(peak_flops=peak, hbm_bw=c.hbm_bw, link_bw=c.nvlink_bw,
                   **fields)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (chips * flops) — remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU given the dominant term."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / self.peak_flops) \
            / self.t_bound

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops_per_chip": self.flops,
            "hlo_bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analytic_hbm_bytes(cfg, shape, chips: int, param_bytes: int,
                       opt_bytes: int = 0,
                       param_shards: Optional[int] = None) -> float:
    """Per-card HBM traffic of a step (bytes), derived from its schedule:

    train:  3x param reads (fwd + remat recompute + bwd) + grad write/read
            + optimizer state read/write + param write
            + activation traffic (residual stream + block io, ~10 tensor
              passes per layer with remat)
            + flash KV re-reads (K,V once per query block)
            + chunked-CE logits write/read (fwd+bwd, chunk-local)
    prefill: 1x param read + activation writes + cache write
    decode:  1x param read + full cache read + one-position cache write
    """
    act = 2                                   # bf16 activations
    d = cfg.d_model
    L = cfg.n_layers
    tokens = shape.global_batch * shape.seq_len / chips
    # params fully sharded when training (FSDP); TP-only when serving
    shards = param_shards or chips
    pb = param_bytes / shards
    ob = opt_bytes / shards

    def attn_layers():
        return sum(reps * sum(1 for k, _ in unit
                              if k in ("global", "local", "mla"))
                   for unit, reps in cfg.layout)

    if shape.step == "train":
        traffic = 3 * pb + 2 * pb + 2 * ob + pb
        traffic += tokens * d * act * L * 10
        # flash KV re-reads: K/V row per query block
        nb = max(shape.seq_len // max(cfg.attn_chunk or shape.seq_len, 1),
                 1)
        kv_row = (cfg.kv_lora_rank + cfg.qk_rope_dim) if cfg.kv_lora_rank \
            else 2 * cfg.n_kv_heads * cfg.hd
        traffic += (shape.global_batch / chips) * shape.seq_len * kv_row \
            * act * attn_layers() * nb * 2          # fwd + bwd repass
        # chunked CE: logits written+read fwd, recomputed in bwd
        traffic += tokens * cfg.padded_vocab * act * 3
        return traffic
    if shape.step == "prefill":
        traffic = pb + tokens * d * act * L * 4
        traffic += tokens * cfg.padded_vocab * act / shape.seq_len  # last
        return traffic
    # decode: params once + cache read (the port's caches, shapes only)
    from ..models import lm_init_cache
    from ..tree import leaves
    cache = lm_init_cache(cfg, shape.global_batch, shape.seq_len,
                          getattr(torch, cfg.kv_dtype), device="meta")
    cache_bytes = sum(math.prod(leaf.shape) * leaf.element_size()
                      for leaf in leaves(cache))
    return pb + cache_bytes / chips * 1.02    # read all + write 1 position


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for training; 2*N_active*D for a forward; decode counts one
    token per sequence."""
    n_active = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention over the cache is folded
    # into the bytes, not the FLOPs
    tokens = shape.global_batch
    return 2.0 * n_active * tokens
