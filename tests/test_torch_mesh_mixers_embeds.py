"""FSDP+TP training of the embedding-input families on a 2 x 2 mesh of
four gloo ranks (spawned processes, ``tests/torch_mesh_worker.py``)
against the reference's sharded training on four forced host devices (one
subprocess for the file, ``tests/torch_mesh_ref.py``): qwen2-vl-2b
(M-RoPE; ``positions3`` (3, B, S) sharded along its batch dim) and
musicgen-medium (four codebook heads, one product a head on the mesh), at
their smoke configs, from the reference's weights and batches (bf16
``embeds``): at the smoke configs' bf16 activations through the
reference's ``train(arch, True, 3, 8, 32, None, model_axis=2)`` and in
f32. Their serving on a mesh is not held here (ROADMAP, what is left of
execution across devices).

Bars (``tests/torch_mesh_ref.py``): f32 losses 1e-5 relative, bf16 2^-9;
every rank's parameters after the steps equal bit for bit; the f32
first-step gradient 1e-4 of each leaf's max.

Cut for the time limit: three steps.
"""
import pytest

import torch_mesh_ref as ref

ARCHS = ("qwen2-vl-2b", "musicgen-medium")
TRAIN = tuple((a, act, 1) for a in ARCHS for act in ("bfloat16", "float32"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_embeds"), train=TRAIN)


def test_reference_trains_from_the_weights_the_port_was_given(runs):
    assert runs[1]["same_weights"] == dict.fromkeys(ARCHS, True)


@pytest.mark.parametrize("job", TRAIN, ids=lambda j: f"{j[0]}-{j[1]}")
def test_fsdp_tp_train_matches_reference(runs, job):
    ref.check_train(runs, job)
