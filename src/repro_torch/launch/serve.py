"""Serving driver: batched decode with TXSQL-style group commit (§4.6.1).

The reference's ``repro.launch.serve``. Requests arriving concurrently are
grouped into a decode batch. The batch "leader" (first waiting request)
fires a step when either the batch is full OR — the dynamic-batch-size
rule — no further requests are waiting; a leader never stalls on an empty
queue. Each fused step is the "group commit": one model invocation serves
the whole conflict group, and finished requests leave in arrival order.

As in the reference, the server decodes every slot from one shared
position counter starting at 0, feeding each request's last prompt token
(no prefill of the prompt), and a slot's cache and recurrent state carry
over from one request to the next. It feeds token ids, so it serves the
token-input architectures; the embedding-input ones (musicgen, qwen2-vl)
are served through ``prefill``/``decode_step`` with ``embeds``, as in the
reference.

On a ``mesh`` (tensor-parallel serving: the parameters placed by the
``serve`` rules) the caches are DTensors placed by ``cache_shardings`` and
each step runs under the mesh; the tokens come back whole to every rank.

    python -m repro_torch.launch.serve [--arch A] [--requests N] [--slots S]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve
from ..distributed.sharding import cache_shardings, distribute, on_mesh
from ..models import decode_step, init_params, lm_spec
from ..models.transformer import lm_init_cache
from .steps import whole


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    order: int = -1                  # group order (hot_update_order analogue)


class GroupServer:
    """Fixed-slot continuous batching with dynamic group fire. ``params``
    lie on ``device`` (default CUDA), as DTensors on ``mesh`` when one is
    given."""

    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 256, device=None, mesh=None):
        if not cfg.embed_inputs:
            raise ValueError(f"GroupServer feeds token ids; {cfg.name} takes "
                             "embeddings: use prefill/decode_step with embeds")
        self.device = resolve(device)
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.mesh = mesh
        self.caches = lm_init_cache(cfg, batch_slots, max_len,
                                    device=self.device)
        if mesh is not None:
            self.caches = distribute(self.caches,
                                     cache_shardings(self.caches, mesh))
        self.pos = 0
        self._order = 0
        self.steps_fired = 0
        self.members_served = 0

    def submit(self, req: Request):
        req.order = self._order            # dependency-list order
        self._order += 1
        self.queue.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.popleft()

    def step(self) -> bool:
        """Fire one fused decode step (group commit). Returns progress."""
        self._admit()
        live = [r for r in self.active if r is not None]
        if not live:
            return False
        # group fire rule: full batch OR queue drained (dynamic batch)
        if len(live) < self.slots and self.queue:
            self._admit()
            live = [r for r in self.active if r is not None]
        toks = np.zeros((self.slots, 1), np.int32)
        for i, r in enumerate(self.active):
            if r is not None:
                toks[i, 0] = (r.out[-1] if r.out else r.prompt[-1])
        with on_mesh(self.mesh):
            nxt_logits, self.caches = decode_step(
                self.params, self.cfg, tokens=torch.from_numpy(toks),
                caches=self.caches, pos=self.pos, device=self.device)
        self.pos += 1
        nxt = torch.argmax(whole(nxt_logits)[:, -1], dim=-1).cpu().numpy()
        self.steps_fired += 1
        # commit in order: requests complete in their arrival order
        done = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.out.append(int(nxt[i]))
            self.members_served += 1
            if len(r.out) >= r.max_new:
                done.append((r.order, i))
        for _, i in sorted(done):          # ordered group commit
            self.active[i] = None
        return True


def serve_demo(arch: str = "qwen2-0.5b", n_requests: int = 12,
               batch_slots: int = 4, smoke: bool = True, seed: int = 0,
               device=None):
    """The reference's demo: ``n_requests`` random 8-token prompts with
    4..8 new tokens each, through ``batch_slots`` slots. ``smoke=False``
    runs the architecture at its full published width."""
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    params = init_params(lm_spec(cfg), seed, device=dev)
    srv = GroupServer(cfg, params, batch_slots=batch_slots, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(n_requests):
        srv.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, 8,
                                               dtype=np.int32),
                           max_new=4 + rid % 5))
    t0 = time.perf_counter()
    while srv.step():
        pass
    dt = time.perf_counter() - t0
    print(f"[serve] {n_requests} requests, {srv.steps_fired} fused steps, "
          f"{srv.members_served} tokens, {dt*1e3:.0f}ms (group efficiency "
          f"{srv.members_served/max(srv.steps_fired,1):.2f} tokens/step)")
    return srv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    args = ap.parse_args()
    serve_demo(args.arch, args.requests, args.slots)


if __name__ == "__main__":
    main()
