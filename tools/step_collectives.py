#!/usr/bin/env python3
"""The collective bytes a rank of one FSDP+TP train step, on this host's
CPU: four spawned gloo ranks, a (2, 2) mesh, each architecture's smoke
config (its own activations, weights of seed 0, ``make_batch``'s first
batch of ``DataConfig(seed=0)``), one warm step, then one step counted by
``CollectiveCounter`` (``tests/torch_mesh_worker.py::step_collectives``).

    PYTHONPATH=<tree>/src python tools/step_collectives.py [ARCH ...]

``<tree>`` is any checkout of the port (this one, or a parent unpacked
with ``git archive``), so two commits compare on one host. One JSON line
an architecture: rank 0's bytes and calls by collective, their total, and
whether every rank counted the same.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(ROOT, "tests"))
from torch_mesh_worker import run_ranks, step_collectives  # noqa: E402

ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")
BATCH, SEQ = 8, 32


def rank_main(rank, arch):
    from repro_torch.launch.mesh import make_host_mesh
    return step_collectives(arch, make_host_mesh(2), BATCH, SEQ)


if __name__ == "__main__":
    import repro_torch
    for arch in sys.argv[1:] or ARCHS:
        got = run_ranks(rank_main, 4, arch)
        per_op, calls = got[0]
        print(json.dumps({"arch": arch, "batch": BATCH, "seq": SEQ,
                          "mesh": [2, 2], "src": os.path.dirname(
                              repro_torch.__file__),
                          "bytes": per_op, "calls": calls,
                          "total_bytes": sum(per_op.values()),
                          "ranks_equal": all(g == got[0] for g in got)}),
              flush=True)
