"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), the reference's
``repro.models.ssd``.

Chunked SSD (the paper's Listing 1): the sequence is split into chunks of
length Q; within a chunk the output is an attention-like quadratic form
masked by the decay kernel; across chunks a linear recurrence carries the
(H, P, N) state (the reference's ``lax.scan`` over chunks, a loop over the
chunks here). Decode is the pure recurrence. Where the reference annotates
the heads over "model", a mesh runs the chunks and the decode step on each
rank's heads (:func:`~repro_torch.distributed.sharding.shard_local`); the
``annotate`` calls inside stand where the reference's do and are the
identity on those local tensors.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim (P = head_dim);
N = ssm_state. B and C projections are shared across heads (n_groups = 1).
The state is always f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import annotate, shard_local
from .common import spec


def ssd_spec(cfg):
    d = cfg.d_model
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.conv_width
    return {
        "w_in": spec((d, 2 * di + 2 * N + H), ("embed", "lru")),
        "conv": spec((cw, di + 2 * N), (None, "lru")),
        "a_log": spec((H,), (None,), init="value", value=0.0),
        "dt_bias": spec((H,), (None,), init="zeros"),
        "d_skip": spec((H,), (None,), init="ones"),
        "norm": spec((di,), ("lru",), init="ones"),
        "w_out": spec((di, d), ("lru", "embed")),
    }


class SSDState(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) ssm state, f32
    conv: torch.Tensor     # (B, conv_width-1, d_inner + 2N), f32


def _split_proj(p, x, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    z_x_b_c_dt = x @ p["w_in"].to(x.dtype)
    z = z_x_b_c_dt[..., :di]
    xbc = z_x_b_c_dt[..., di:2 * di + 2 * N]
    dt = z_x_b_c_dt[..., 2 * di + 2 * N:]
    return z, xbc, dt


def _conv1d(p, u, state=None):
    cw = p["conv"].shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = sum(full[:, i:i + S] * p["conv"][i].to(u.dtype) for i in range(cw))
    tail = full[:, -(cw - 1):] if cw > 1 else pad
    return F.silu(out), tail


def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum(a[j+1 .. i]) for j <= i, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def _gated_norm(y, z, p):
    """mamba2's gated RMSNorm before the output projection (f32)."""
    y = y * F.silu(z.to(torch.float32))
    var = y.square().mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * p["norm"].to(torch.float32)


def _chunks(xs, Bm, Cm, dt, A, Q: int):
    """Steps 1-4 of the chunked SSD on heads that never mix: xs (B, S, H,
    P), Bm and Cm (B, S, N), dt (B, S, H) f32, A (H,) -> (y (B, S, H, P)
    f32 before the skip, the last state (B, H, P, N))."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    nc = S // Q
    assert S % Q == 0, f"seq {S} not divisible by chunk {Q}"
    xc = xs.reshape(B, nc, Q, H, P)
    bc = Bm.reshape(B, nc, Q, N)
    cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    da = dtc * A                                      # (B,nc,Q,H)

    # 1. intra-chunk (attention-like with decay kernel), in the
    # reference's explicit contraction order
    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))    # (B,nc,H,Q,Q)
    L = annotate(L, "batch", None, "model", None, None)
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)  # (B,nc,Q,Q)
    w = scores[:, :, None].to(f32) * L                # (B,nc,H,Q,Q)
    xdt = xc.to(f32) * dtc.to(f32)[..., None]         # (B,nc,Q,H,P)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", w, xdt)
    y_diag = annotate(y_diag, "batch", None, None, "model", None)

    # 2. per-chunk end states
    dec_end = torch.exp(da.sum(dim=2, keepdim=True)
                        - torch.cumsum(da, dim=2))    # decay to chunk end
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bc.to(f32),
                          (dtc * dec_end).to(f32),
                          xc.to(f32))                 # (B,nc,H,P,N)
    states = annotate(states, "batch", None, "model", None, None)

    # 3. inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(da.sum(dim=2))            # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=f32, device=xs.device)
    hs = []
    for c in range(nc):
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
        hs.append(h)
    hs = torch.stack(hs, dim=1)                       # (B,nc,H,P,N)
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)

    # 4. inter-chunk contribution: h_prev reaches step t decayed by the
    # *inclusive* prefix exp(sum_{j<=t} da_j)
    dec_in = torch.exp(torch.cumsum(da, dim=2))
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc.to(f32),
                         dec_in.to(f32), h_prev)
    y = annotate((y_diag + y_off).reshape(B, S, H, P),
                 "batch", None, "model", None)
    return y, hs[:, -1]


def _step(h0, xs, Bm, Cm, dt1, A):
    """One decode step of the recurrence: h0 (B, H, P, N), xs (B, H, P),
    Bm and Cm (B, N), dt1 (B, H) f32, A (H,) -> (y (B, H, P) before the
    skip, h (B, H, P, N))."""
    f32 = torch.float32
    decay = torch.exp(dt1 * A)                            # (B,H)
    dbx = torch.einsum("bn,bh,bhp->bhpn", Bm.to(f32), dt1, xs.to(f32))
    h = h0 * decay[..., None, None] + dbx
    return torch.einsum("bn,bhpn->bhp", Cm.to(f32), h), h


# (batch dim, heads dim) of _chunks' and _step's arguments and outputs: on
# a mesh they run on each rank's batch rows and heads (shard_local), as
# the reference's annotations place the heads over "model"
_CHUNK_DIMS = ((0, 2), (0, None), (0, None), (0, 2), (None, 0))
_STEP_DIMS = ((0, 1), (0, 1), (0, None), (0, None), (0, 1), (None, 0))


def ssd(p, x, cfg, mode: str, state: SSDState | None = None):
    """x: (B, S, d) -> (out, new_state|None)."""
    B, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc, dt = _split_proj(p, x, cfg)
    A = -torch.exp(p["a_log"].to(f32))                    # (H,) negative
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))    # (B,S,H)

    if mode in ("train", "prefill"):
        xbc, conv_tail = _conv1d(p, xbc)
        xs = annotate(xbc[..., :di].reshape(B, S, H, P),
                      "batch", None, "model", None)
        Bm = xbc[..., di:di + N]                          # (B,S,N)
        Cm = xbc[..., di + N:]                            # (B,S,N)
        Q = min(cfg.ssm_chunk, S)
        y, h_last = shard_local(lambda *a: _chunks(*a, Q),
                                (xs, Bm, Cm, dt, A), _CHUNK_DIMS,
                                ((0, 2), (0, 1)))
        y = y + p["d_skip"].to(f32)[None, None, :, None] * xs.to(f32)
        y = _gated_norm(y.reshape(B, S, di), z, p)
        out = y.to(x.dtype) @ p["w_out"].to(x.dtype)
        new_state = None
        if mode == "prefill":
            new_state = SSDState(h=h_last, conv=conv_tail.to(f32))
        return out, new_state

    # ------------------------------------------------------------ decode
    assert state is not None
    xbc, conv_tail = _conv1d(p, xbc, state.conv)
    xs = xbc[..., :di].reshape(B, H, P)                   # S == 1 squeezed
    Bm = xbc[:, 0, di:di + N]                             # (B,N)
    Cm = xbc[:, 0, di + N:]
    y, h = shard_local(_step, (state.h, xs, Bm, Cm, dt[:, 0], A),
                       _STEP_DIMS, ((0, 1), (0, 1)))
    y = y + p["d_skip"].to(f32)[None, :, None] * xs.to(f32)
    y = _gated_norm(y.reshape(B, di), z[:, 0], p)
    out = y.to(x.dtype) @ p["w_out"].to(x.dtype)
    return out[:, None], SSDState(h=h, conv=conv_tail.to(f32))
