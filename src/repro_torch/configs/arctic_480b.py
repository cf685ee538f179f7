"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    layout=(((("global", "moe+dense"),), 35),),
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,              # dense residual MLP width
    vocab=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    rope_theta=1e4,
    vocab_pad_to=256,
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-480b-smoke",
    layout=(((("global", "moe+dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    n_experts=8, top_k=2, moe_d_ff=64, remat=False)
