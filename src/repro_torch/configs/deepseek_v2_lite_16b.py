"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + routed top-6
[arXiv:2405.04434; hf]. Layer 0 is dense, remaining 26 are MoE."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    layout=(
        ((("mla", "dense"),), 1),
        ((("mla", "moe"),), 26),
    ),
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,             # dense layer-0 FFN
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_theta=1e4,
    vocab_pad_to=256,
    source="arXiv:2405.04434",
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-v2-lite-16b-smoke",
    layout=(((("mla", "dense"),), 1), ((("mla", "moe"),), 1)),
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
    kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
    remat=False)
