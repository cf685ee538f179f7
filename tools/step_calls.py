#!/usr/bin/env python3
"""Count the torch calls one untraced iteration of the port's engine step
issues, per protocol, on the CPU.

    PYTHONPATH=src python tools/step_calls.py [--threads 16] [--iters 4]

The step dispatches every torch call from the host, so on the card its
count sets an iteration's cost. Counting with a ``TorchFunctionMode`` (every
torch function, tensor method and operator the step calls, once each) needs
no card. Uses only what every version of ``repro_torch.core.lock.engine``
since the lane axis has (``_lanes``, ``_make_step``, ``_unsqueeze``), so the
same script counts any commit's step: point ``PYTHONPATH`` at its ``src``.
"""
from __future__ import annotations

import argparse
import json

from torch.overrides import TorchFunctionMode

PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo", "brook2pl")


class CallCount(TorchFunctionMode):
    """Counts the torch calls made while it is active (``n``)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def calls_per_iter(step, s, iters: int = 4):
    """Torch calls per call of ``step`` (a state -> state function) over
    ``iters`` calls from ``s``; returns the count and the last state."""
    with CallCount() as c:
        for _ in range(iters):
            s = step(s)
    return c.n / iters, s


def step_calls(protocol: str, threads: int = 16, iters: int = 4,
               warmup: int = 8) -> float:
    """Torch calls per iteration of the untraced step: hotspot update
    (txn_len 4, R=256, attribution on, p_abort 0.05), counted over
    ``iters`` iterations after ``warmup``."""
    from repro_torch.core.lock import engine
    from repro_torch.core.lock import CostModel, WorkloadSpec, protocol_params
    cfg = engine.EngineConfig(
        protocol=protocol_params(protocol), costs=CostModel(),
        workload=WorkloadSpec(kind="hotspot_update", txn_len=4, n_rows=256),
        n_threads=threads, horizon=1_000_000, p_abort=0.05, attrib=True)
    stat, dp = engine.split_config(cfg, device="cpu")
    step = engine._make_step(stat, engine._lanes(dp))
    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    for _ in range(warmup):
        s = step(s)
    return calls_per_iter(step, s, iters)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()
    print(json.dumps({p: step_calls(p, args.threads, args.iters)
                      for p in PROTOCOLS}))


if __name__ == "__main__":
    main()
