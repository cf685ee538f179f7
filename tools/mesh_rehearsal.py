#!/usr/bin/env python3
"""The sharded model paths on this host's torch, without JAX: a rehearsal
for a host whose torch differs from the one the CPU tests run on (DTensor's
rules differ by version).

    PYTHONPATH=src:tests python tools/mesh_rehearsal.py [ARCH|seqpar ...]

Runs the CPU tests' jobs (``tests/torch_mesh_worker.run_jobs``) on weights
and batches the port makes itself, on a (2, 2) mesh of four spawned gloo
ranks against the same jobs on one device: for each architecture (default:
every family) at its smoke config in f32 activations, three FSDP+TP train
steps (losses, the first step's gradients, every rank's parameters after
the steps) and a TP prefill of 2 x 16 tokens (embeddings, with their
M-RoPE streams, for qwen2-vl-2b and musicgen-medium) + 1 decode step; with
no ARCH, first the MoE layer's output, stats and gradients at
capacity factor 0.5 (``moe_data_shards`` 1 and 2, ``train`` and ``serve``
placements), and the sequence-parallel residual
(``tests/torch_mesh_worker.run_seqpar``: qwen2-0.5b with remat and chunked
CE, the residual each unit's checkpoint keeps and each block's input in a
prefill of 16 and of 15 positions and a decode step, every rank's local
shape and placements; loss and logits against one device; the collective
bytes of a step). One JSON line a case; a raised error is printed in the
line, not raised.
"""
import json
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
from torch_mesh_worker import (jobs_rank, run_jobs,  # noqa: E402
                               run_ranks, run_seqpar, seqpar_rank,
                               serve_inputs)

ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b", "arctic-480b", "mamba2-1.3b",
         "recurrentgemma-2b", "gemma3-12b", "qwen2-vl-2b", "musicgen-medium")
MOE_ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")
STEPS, B, S = 3, 8, 32


def jobs(arch=None, ds=1):
    """The jobs of one case: an architecture's (weights of ``init_params``
    at seed 0, ``make_batch``'s batches of ``DataConfig(seed=0)``), or
    with ``arch`` None the MoE layer's at ``moe_data_shards`` ``ds``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.models import init_params, lm_spec
    from repro_torch.models.convert import _host, params_to_numpy
    from repro_torch.models.moe import moe_spec
    d = {"train": [], "serve": [], "moe": {}, "params": {}, "batches": {},
         "tokens": np.random.default_rng(3).integers(
             0, 256, (2, 17)).astype(np.int32)}
    if arch is None:
        for a in MOE_ARCHS:
            cfg = get_config(a, smoke=True)
            rng = np.random.default_rng(1)
            x, w = (rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
                    for _ in range(2))
            d["moe"][a, ds, 0.5] = (params_to_numpy(
                init_params(moe_spec(cfg), 0, device="cpu")), x, w)
        return d
    cfg = get_config(arch, smoke=True)
    d["params"][arch] = params_to_numpy(init_params(lm_spec(cfg), 0,
                                                    device="cpu"))
    dstate, batches = init_state(), []
    for _ in range(STEPS):
        b, dstate = make_batch(DataConfig(seed=0), cfg, B, S, dstate,
                               device="cpu")
        batches.append({k: _host(v) for k, v in b.items()})
    d["batches"][arch] = batches
    d["train"] = [(arch, "float32", ds)]
    d["serve"] = [(arch, ds)]
    if not cfg.embed_inputs:
        d["serve_inputs"] = {arch: serve_inputs(cfg, 2, 17)}
    return d


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max()
                 / (np.abs(b).max() + 1e-12))


def compare(got, one):
    """Rank 0's results against one device's, and every rank's parameters
    after training against rank 0's."""
    from repro_torch.tree import leaves
    out = {}
    for job, r in got[0]["train"].items():
        o = one["train"][job]
        out["train"] = dict(
            losses=(r["losses"], o["losses"]),
            grad_rel=max(rel(a, b) for a, b in zip(leaves(r["grads"]),
                                                   leaves(o["grads"]))),
            params_same_on_ranks=all(
                all(np.array_equal(a, b) for a, b in zip(
                    leaves(g["train"][job]["params"]), leaves(r["params"])))
                for g in got))
    for key, r in got[0]["serve"].items():
        o = one["serve"][key]
        out[f"serve kernel={key[2]}"] = dict(
            logits_rel=rel(r["logits"], o["logits"]),
            next_equal=bool(np.array_equal(r["next"], o["next"])))
    for case, r in got[0]["moe"].items():
        o = one["moe"][case]
        out[str(case[:2])] = dict(
            y_rel=rel(r["y"], o["y"]),
            counts_equal=bool(np.array_equal(r["counts"], o["counts"])),
            dropped=(r["dropped"], o["dropped"]),
            grad_rel=max(rel(a, b) for a, b in zip(r["grads"], o["grads"])),
            placed=r["placed"])
    return out


def seqpar_jobs():
    """The jobs of the sequence-parallel case: qwen2-0.5b's weights and
    first batch, a 2 x 17 prompt, chunked CE of 8-position chunks."""
    d = jobs("qwen2-0.5b")
    d["seqpar"] = {"arch": "qwen2-0.5b", "loss_chunk": 8,
                   "collectives": ("qwen2-0.5b", "deepseek-v2-lite-16b"),
                   "step_shape": (B, S)}
    return d


def seqpar_compare(got, one):
    """Every rank's residual shapes and placements, rank 0's loss and
    logits against one device's, the collective bytes a rank."""
    def blocks(r, name, mode):
        return sorted({(str(b[1]), str(b[2])) for b in r["serve"][name]
                       ["blocks"] if b[0] == mode})
    out = {"loss": (got[0]["loss"], one["loss"]),
           "loss_rel": abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])}
    for r, g in enumerate(got):
        out[f"rank{r}"] = dict(
            saved=sorted({(str(a), str(b)) for a, b in g["saved"]}),
            prefill16=blocks(g, "even", "prefill"),
            prefill15=blocks(g, "odd", "prefill"),
            decode=blocks(g, "even", "decode"))
    for name in ("even", "odd"):
        r, o = got[0]["serve"][name], one["serve"][name]
        out[f"serve {name}"] = dict(
            logits_rel=rel(r["logits"], o["logits"]),
            next_equal=bool(np.array_equal(r["next"], o["next"])))
    out["collective_bytes"] = {a: sum(c[0].values()) for a, c in
                               got[0]["collectives"].items()}
    return out


def rehearse(tmp, name, d, moe_rules="train"):
    t0 = time.time()
    line = {"case": name}
    try:
        path = os.path.join(tmp, "in.pkl")
        with open(path, "wb") as f:
            pickle.dump(d, f)
        if "seqpar" in d:
            got = run_ranks(seqpar_rank, 4, path, 2)
            line.update(seqpar_compare(got, run_seqpar(d, None)))
        else:
            got = run_ranks(jobs_rank, 4, path, 2, moe_rules)
            line.update(compare(got, run_jobs(d, None, moe_rules)))
    except Exception:
        line["error"] = traceback.format_exc()[-2500:]
    line["s"] = time.time() - t0
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    import torch
    print("torch", torch.__version__, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if not sys.argv[1:]:
            for ds in (1, 2):
                for rules in ("train", "serve"):
                    rehearse(tmp, f"moe ds={ds} {rules}", jobs(None, ds),
                             rules)
        for arch in sys.argv[1:] or ("seqpar",) + ARCHS:
            if arch == "seqpar":
                rehearse(tmp, "seqpar", seqpar_jobs())
                continue
            for ds in (1, 2) if arch == "deepseek-v2-lite-16b" else (1,):
                rehearse(tmp, f"{arch} ds={ds}", jobs(arch, ds))
