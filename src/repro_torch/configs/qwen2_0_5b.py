"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    layout=(((("global", "dense"),), 24),),
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    vocab_pad_to=256,
    source="arXiv:2407.10671",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-0.5b-smoke",
    layout=(((("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    remat=False)
