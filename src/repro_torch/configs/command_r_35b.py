"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified]."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    layout=(((("global", "dense"),), 40),),
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    rope_theta=8e6,
    vocab_pad_to=256,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE = dataclasses.replace(
    CONFIG, name="command-r-35b-smoke",
    layout=(((("global", "dense"),), 2),),
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    remat=False)
