"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196; hf]."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    layout=(((("global", "dense"),), 62),),
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    head_dim=128,
    rope_theta=1e5,
    vocab_pad_to=256,
    source="arXiv:2401.14196",
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-coder-33b-smoke",
    layout=(((("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    remat=False)
