"""Deterministic synthetic data pipeline, per-host sharded and
checkpointable (the reference's ``repro.data.pipeline``).

Token streams are Zipf-distributed, so embedding-row hotspots are real in
training. Every batch is a pure function of (seed, host, step): a
``torch.Generator`` on the CPU, seeded from the three, draws it, and the
batch then moves to the device, so the CPU and the card get the same
batch and a restart at step k reproduces batch k. torch cannot reproduce
``jax.random``'s stream, so the numbers differ from the reference's; the
distributions and shapes are the same.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.lock.workload import zipf_cdf
from ..device import resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_s: float = 1.0          # natural-language-like token skew
    n_hosts: int = 1
    host_id: int = 0


class DataState(NamedTuple):
    step: torch.Tensor           # () int32 on the CPU: the only state


def init_state() -> DataState:
    return DataState(step=torch.zeros((), dtype=torch.int32))


def _generator(dc: DataConfig, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, host_id, step), mixed by numpy's
    SeedSequence so that neighbouring triples give unrelated streams."""
    words = np.random.SeedSequence(
        (dc.seed, dc.host_id, step)).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator().manual_seed(seed)


def make_batch(dc: DataConfig, cfg, batch: int, seq: int, state: DataState,
               device=None):
    """Synthesize one LM batch for this host on ``device`` (default CUDA).
    Returns (batch dict, next state). Token inputs: ``tokens`` (B, S) and
    ``labels`` (B, S) shifted by one, drawn from Zipf(``zipf_s``) over the
    vocabulary; embedding inputs: bf16 ``embeds`` (B, S, d) and uniform
    labels, (B, S, K) with K codebooks; ``positions3`` (3, B, S) with
    M-RoPE."""
    dev = resolve(device)
    step = int(state.step)
    gen = _generator(dc, step)
    out = {}
    if cfg.embed_inputs:
        u = torch.rand((batch, seq + 1), generator=gen)
        cdf = torch.from_numpy(zipf_cdf(cfg.vocab, dc.zipf_s))
        toks = torch.searchsorted(cdf, u).to(torch.int32)
        toks = toks.clamp(0, cfg.vocab - 1)
        out["tokens"] = toks[:, :seq]
        out["labels"] = toks[:, 1:]
    else:
        out["embeds"] = torch.randn((batch, seq, cfg.d_model),
                                    generator=gen).to(torch.bfloat16)
        shape = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks \
            else (batch, seq)
        out["labels"] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                      dtype=torch.int32)
    if cfg.mrope:
        base = torch.arange(seq, dtype=torch.int32)[None, None]
        out["positions3"] = base.expand(3, batch, seq)
    out = {k: v.contiguous().to(dev) for k, v in out.items()}
    return out, DataState(step=state.step + 1)
