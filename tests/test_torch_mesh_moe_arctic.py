"""arctic-480b (dense + residual MoE, GQA) on a 2 x 2 mesh of four gloo
ranks (spawned processes, ``tests/torch_mesh_worker.py``) against the
reference on four forced host devices (one subprocess for the file,
``tests/torch_mesh_ref.py``).

Training (FSDP+TP): three steps of 8 x 32 at the smoke config from the
reference's weights and batches, at bf16 activations through the
reference's ``train("arctic-480b", True, 3, 8, 32, None, model_axis=2)``
and in f32. Serving (TP, f32): prefill of a 2 x 16 prompt on the plain and
the kernel path (the flash wrapper on each rank's local heads; on the CPU
its plain version) and one decode step.

Bars (``tests/torch_mesh_ref.py``): f32 losses 1e-5 relative, bf16 2^-9;
logits and caches 2e-4; the next token equal; every rank's parameters after
the steps equal bit for bit; the f32 first-step gradient 1e-4 of each leaf's
max.

Cut for the time limit: three steps.
"""
import pytest

import torch_mesh_ref as ref

ARCH = "arctic-480b"
TRAIN = ((ARCH, "bfloat16", 1), (ARCH, "float32", 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_arctic"), train=TRAIN,
                   serve=((ARCH, 1),))


def test_reference_trains_from_the_weights_the_port_was_given(runs):
    assert runs[1]["same_weights"] == {ARCH: True}


@pytest.mark.parametrize("job", TRAIN, ids=lambda j: j[1])
def test_fsdp_tp_train_matches_reference(runs, job):
    ref.check_train(runs, job)


@pytest.mark.parametrize("kernel", [False, True])
def test_tp_prefill_and_decode_match_reference(runs, kernel):
    ref.check_serve(runs, (ARCH, 1, kernel))
