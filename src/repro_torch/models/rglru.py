"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
reference's ``repro.models.rglru``.

Block structure (the paper's "recurrent block"):
  x -> [linear -> gelu] (gate branch)
  x -> [linear -> conv1d(w=4) -> RG-LRU] (recurrent branch)
  out = (gate * rec) -> linear

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_a x_t + b_a)            recurrence gate
  i_t = sigmoid(W_x x_t + b_x)            input gate
  a_t = exp(-c * softplus(L) * r_t)       log-space decay, c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill runs the recurrence as a scan over time. The reference uses
``lax.associative_scan``; torch has none, and a loop over S would issue S
launches a layer, so :func:`_linear_scan` is a log-depth (Hillis–Steele)
scan: ceil(log2 S) steps of elementwise ops over the whole sequence. Decode
carries (h, conv window) state, always f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import reduce_partial
from .common import spec

C_RGLRU = 8.0


def rglru_spec(cfg):
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv_width
    return {
        "w_gate": spec((d, w), ("embed", "lru")),
        "w_in": spec((d, w), ("embed", "lru")),
        "conv": spec((cw, w), (None, "lru"), init="dense"),
        "w_a": spec((w, w), ("lru", "lru")),
        "b_a": spec((w,), ("lru",), init="zeros"),
        "w_x": spec((w, w), ("lru", "lru")),
        "b_x": spec((w,), ("lru",), init="zeros"),
        "log_lambda": spec((w,), ("lru",), init="value", value=0.5),
        "w_out": spec((w, d), ("lru", "embed")),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor         # (B, W) recurrent state, f32
    conv: torch.Tensor      # (B, conv_width-1, W) conv tail, f32


def _gates(p, u):
    # on a mesh the (lru, lru) products come out partial over "model":
    # reduced before the bias, which is sharded (reduce_partial)
    r = torch.sigmoid(reduce_partial(u @ p["w_a"].to(u.dtype))
                      + p["b_a"].to(u.dtype))
    i = torch.sigmoid(reduce_partial(u @ p["w_x"].to(u.dtype))
                      + p["b_x"].to(u.dtype))
    lam = F.softplus(p["log_lambda"].to(torch.float32))
    log_a = -C_RGLRU * lam * r.to(torch.float32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i.to(torch.float32) * u.to(torch.float32))
    return a, gated


def _conv1d(p, u, state=None):
    """Causal depthwise conv along time. u: (B, S, W). Returns (out, the
    last conv_width-1 inputs)."""
    cw = p["conv"].shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = sum(full[:, i:i + S] * p["conv"][i].to(u.dtype) for i in range(cw))
    return out, full[:, -(cw - 1):] if cw > 1 else pad


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along axis 1, as a
    Hillis–Steele scan of the pairs (a, b) under (a1, b1) . (a2, b2) =
    (a1 a2, b1 a2 + b2): after the step of span s, position t holds the
    composition of steps t-2s+1 .. t."""
    S = a.shape[1]
    s = 1
    while s < S:
        b = torch.cat([b[:, :s], b[:, :-s] * a[:, s:] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return b


def rglru(p, x, cfg, mode: str, state: RGLRUState | None = None):
    """x: (B, S, d) -> (out, new_state|None)."""
    gate = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh")
    u = x @ p["w_in"].to(x.dtype)

    if mode in ("train", "prefill"):
        u, conv_tail = _conv1d(p, u)
        a, gated = _gates(p, u)
        h = _linear_scan(a, gated)
        out = (h * gate.to(torch.float32)).to(x.dtype) @ \
            p["w_out"].to(x.dtype)
        new_state = None
        if mode == "prefill":
            new_state = RGLRUState(h=h[:, -1].to(torch.float32),
                                   conv=conv_tail.to(torch.float32))
        return out, new_state

    # decode: single step
    assert state is not None
    u, conv_tail = _conv1d(p, u, state.conv)
    a, gated = _gates(p, u)
    h = a[:, 0] * state.h + gated[:, 0]
    out = (h * gate[:, 0].to(torch.float32)).to(x.dtype) @ \
        p["w_out"].to(x.dtype)
    return out[:, None], RGLRUState(h=h, conv=conv_tail.to(torch.float32))
