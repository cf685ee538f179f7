"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free
[arXiv:2405.21060; unverified]. Vocab padded to 50432 for sharding (the
model's logical vocab 50280 is kept for losses/logits masking)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    layout=(((("ssd", "none"),), 48),),
    d_model=2048,
    n_heads=1,                # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    vocab_pad_to=256,         # 50280 -> 50432 (divisible by 256)
    source="arXiv:2405.21060",
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-1.3b-smoke",
    layout=(((("ssd", "none"),), 2),),
    d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_chunk=8, remat=False)
