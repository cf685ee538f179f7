"""Model configuration system: architectures, layer layouts, input shapes.

A verbatim copy of ``repro.configs.base`` (the port imports nothing of the
reference). A ``ModelConfig`` fully describes one architecture. Layers are
organized in **layer groups** ``(unit, repeats)``: a unit is a short tuple of
layer kinds (e.g. five sliding-window attention layers followed by one global
layer for gemma3). The reference compiles a group as one ``lax.scan`` over
``repeats`` with parameters stacked on a leading axis; the port runs it as a
Python loop over ``repeats`` with one parameter dict per layer
(``repro_torch.models.transformer``).

A ``LayerKind`` is ``(mixer, mlp)``:
  mixer: "global" | "local" | "mla" | "rglru" | "ssd"
  mlp:   "dense" | "moe" | "moe+dense" | "none"
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

LayerKind = Tuple[str, str]
LayerGroup = Tuple[Tuple[LayerKind, ...], int]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    layout: Tuple[LayerGroup, ...]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention
    window: int = 4096          # sliding-window size for "local"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope: bool = False         # qwen2-vl 3-section M-RoPE
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # data-shard-local dispatch: capacity grids are per data shard (set to
    # the mesh's data-parallel size in distributed runs; EP all-to-alls
    # then move only shard-local capacity, not global)
    moe_data_shards: int = 1
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    conv_width: int = 4
    # SSD (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # embedding / head
    n_codebooks: int = 0        # musicgen: output heads over codebooks
    embed_inputs: bool = True   # False: frontend stub feeds embeddings
    vocab_pad_to: int = 1       # pad vocab to a multiple (sharding)
    norm_eps: float = 1e-6
    # training
    remat: bool = True
    zloss: float = 1e-4
    act_dtype: str = "bfloat16"   # activation/cache dtype
    loss_chunk: int = 0           # sequence-chunked CE (0 = off); keeps
                                  # logits from ever materializing fully
    attn_chunk: int = 0           # query-block-chunked attention (0 = off);
                                  # scores exist one (blk x S) slab at a
                                  # time (flash-style memory, XLA-level)
    unroll_layers: bool = False   # python-loop layer groups (cost probes)
    kv_dtype: str = "bfloat16"    # KV-cache storage dtype; "float8_e4m3fn"
                                  # halves decode HBM traffic (hillclimb)
    # citation / provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(len(unit) * reps for unit, reps in self.layout)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def kinds(self) -> set:
        return {k for unit, _ in self.layout for k in unit}

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        n = 0
        if self.embed_inputs:
            n += self.padded_vocab * d
        heads_out = self.n_codebooks or 1
        n += heads_out * self.padded_vocab * d          # lm head(s)
        for unit, reps in self.layout:
            for mixer, mlp in unit:
                if mixer in ("global", "local"):
                    n += reps * d * hd * (self.n_heads * 2
                                          + self.n_kv_heads * 2)
                elif mixer == "mla":
                    qk = self.qk_nope_dim + self.qk_rope_dim
                    n += reps * (d * self.n_heads * qk
                                 + d * (self.kv_lora_rank + self.qk_rope_dim)
                                 + self.kv_lora_rank * self.n_heads
                                 * (self.qk_nope_dim + self.v_head_dim)
                                 + self.n_heads * self.v_head_dim * d)
                elif mixer == "rglru":
                    w = self.lru_width
                    n += reps * (2 * d * w + w * d + 3 * w
                                 + self.conv_width * w)
                elif mixer == "ssd":
                    di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
                    n += reps * (d * (2 * di + 2 * ns + hh)
                                 + di * d + self.conv_width * (di + 2 * ns))
                if mlp == "dense":
                    n += reps * 3 * d * self.d_ff
                elif mlp in ("moe", "moe+dense"):
                    n += reps * (self.n_experts * 3 * d * self.moe_d_ff
                                 + self.n_shared_experts * 3 * d
                                 * self.moe_d_ff + d * self.n_experts)
                    if mlp == "moe+dense":
                        n += reps * 3 * d * self.d_ff
                n += reps * 2 * d                        # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(reps * sum(1 for _, m in unit if "moe" in m)
                         for unit, reps in self.layout)
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 \
            * self.d_model * self.moe_d_ff
        return full - inactive


# ---------------------------------------------------------------------------
# assigned input shapes (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs with a sub-quadratic decode path run long_500k; pure full-attention
# archs skip it (documented in DESIGN.md §4).
SUBQUADRATIC = {"gemma3-12b", "recurrentgemma-2b", "mamba2-1.3b"}


def shape_grid(arch_name: str):
    """The assigned (shape) cells for one architecture."""
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and arch_name not in SUBQUADRATIC:
            continue
        yield SHAPES[s]
