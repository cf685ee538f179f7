"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
import dataclasses
from .base import ModelConfig

_UNIT = (("local", "dense"),) * 5 + (("global", "dense"),)

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    layout=((_UNIT, 8),),               # 48 layers
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=240,
    window=1024,
    rope_theta=1e6,
    vocab_pad_to=256,
    source="hf:google/gemma-3-1b-pt",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-12b-smoke",
    layout=(((("local", "dense"),) * 2 + (("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    window=16, remat=False)
