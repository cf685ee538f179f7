"""Tensor-parallel serving of the embedding-input families on a 2 x 2 mesh
of four gloo ranks (spawned processes, ``tests/torch_mesh_worker.py``)
against the reference's sharded prefill and decode on four forced host
devices (one subprocess for the file, ``tests/torch_mesh_ref.py``):
qwen2-vl-2b (M-RoPE: three distinct position streams) and musicgen-medium
(four codebook heads), at their smoke configs in f32, from the reference's
weights placed by the ``serve`` rules, on f32 embeddings of 2 x 16
positions (``torch_mesh_worker.serve_inputs``) and one decode step of a
17th, through ``make_prefill_step`` and ``make_serve_step`` with
``embeds`` (``GroupServer`` refuses these architectures), on the plain
path and on the kernel path (the flash wrapper on each rank's local heads;
on the CPU its plain version).

Bars (``tests/torch_mesh_ref.py::check_serve``): logits within 2e-4 of
the reference's max |logit|, caches after the prefill and after the
decode step within 2e-4, the next tokens (one per codebook for musicgen)
equal.
"""
import pytest

import torch_mesh_ref as ref

ARCHS = ("qwen2-vl-2b", "musicgen-medium")
SERVE = tuple((a, 1) for a in ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_serve_embeds"),
                   serve=SERVE)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_with_embeds_match_reference(runs, arch,
                                                            kernel):
    assert (arch, 1, kernel) in runs[0][0]["serve"], "a global layer"
    ref.check_serve(runs, (arch, 1, kernel))
