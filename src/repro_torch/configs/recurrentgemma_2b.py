"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, pattern
(rec, rec, attn) x 8 + 2 rec = 26 layers [arXiv:2402.19427; hf]."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    layout=(
        (((("rglru", "dense")), ("rglru", "dense"), ("local", "dense")), 8),
        ((("rglru", "dense"),), 2),
    ),
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=1e4,
    vocab_pad_to=256,
    source="arXiv:2402.19427",
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-2b-smoke",
    layout=(((("rglru", "dense"), ("local", "dense")), 2),),
    d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, head_dim=16,
    window=16, lru_width=64, remat=False)
