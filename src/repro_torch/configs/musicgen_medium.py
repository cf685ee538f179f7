"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. Frontend stub: input_specs() provides precomputed
frame embeddings; the model emits 4 parallel codebook heads."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    layout=(((("global", "dense"),), 48),),
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    head_dim=64,
    n_codebooks=4,
    embed_inputs=False,       # EnCodec frontend stub
    rope_theta=1e4,
    vocab_pad_to=128,
    source="arXiv:2306.05284",
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-medium-smoke",
    layout=(((("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=64, head_dim=16,
    n_codebooks=2, remat=False)
