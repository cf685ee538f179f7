"""FSDP+TP training of gemma3-12b (local windows + global layers) on a
2 x 2 mesh of four gloo ranks (spawned processes,
``tests/torch_mesh_worker.py``) against the reference's sharded training
on four forced host devices (one subprocess for the file,
``tests/torch_mesh_ref.py``), at its smoke config, from the reference's
weights and batches: at the smoke config's bf16 activations through the
reference's ``train("gemma3-12b", True, 3, 8, 32, None, model_axis=2)``
and in f32. Its serving on the mesh is in ``tests/test_torch_mesh_serve.py``.

Bars (``tests/torch_mesh_ref.py``): f32 losses 1e-5 relative, bf16 2^-9;
every rank's parameters after the steps equal bit for bit; the f32
first-step gradient 1e-4 of each leaf's max.

Cut for the time limit: three steps.
"""
import pytest

import torch_mesh_ref as ref

ARCH = "gemma3-12b"
TRAIN = ((ARCH, "bfloat16", 1), (ARCH, "float32", 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_attention"), train=TRAIN)


def test_reference_trains_from_the_weights_the_port_was_given(runs):
    assert runs[1]["same_weights"] == {ARCH: True}


@pytest.mark.parametrize("job", TRAIN, ids=lambda j: j[1])
def test_fsdp_tp_train_matches_reference(runs, job):
    ref.check_train(runs, job)
