"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Frontend stub: input_specs() provides merged (text+patch) embeddings and
3-stream M-RoPE position ids."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    layout=(((("global", "dense"),), 28),),
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    embed_inputs=False,       # vision/text merge stub
    rope_theta=1e6,
    vocab_pad_to=256,
    source="arXiv:2409.12191",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-vl-2b-smoke",
    layout=(((("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    remat=False)
