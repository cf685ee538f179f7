"""Step functions driven by serve.py (the reference's
``repro.launch.steps`` without the train step; training is not ported)."""
from __future__ import annotations

import torch

from ..models import decode_step, prefill


def make_prefill_step(cfg, use_kernel=False, max_len=None, device=None):
    """``prefill_step(params, inputs) -> (last-token logits, caches)``.
    ``max_len`` (not in the reference's step, which sizes the caches to the
    prompt) leaves cache room for the tokens a serve step decodes next."""
    def prefill_step(params, inputs):
        return prefill(params, cfg, tokens=inputs.get("tokens"),
                       embeds=inputs.get("embeds"),
                       positions3=inputs.get("positions3"),
                       use_kernel=use_kernel, max_len=max_len, device=device)
    return prefill_step


def make_serve_step(cfg, device=None):
    """``serve_step(params, inputs) -> (next tokens (B,) i32, caches)``:
    greedy argmax over the padded vocabulary, as in the reference."""
    def serve_step(params, inputs):
        logits, caches = decode_step(
            params, cfg, tokens=inputs.get("tokens"),
            embeds=inputs.get("embeds"), caches=inputs["caches"],
            pos=inputs["pos"], positions3=inputs.get("positions3"),
            device=device)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches
    return serve_step
