"""deepseek-v2-lite-16b (MoE + shared expert, MLA, the latent cache) on a
2 x 2 mesh of four gloo ranks (spawned processes,
``tests/torch_mesh_worker.py``) against the reference on four forced host
devices (one subprocess for the file, ``tests/torch_mesh_ref.py``), at the
smoke config, from the reference's weights (``init_params`` at
``PRNGKey(0)``).

Training (FSDP+TP, the ``train`` rules): three steps of 8 x 32 on the
reference's ``make_batch`` batches of ``DataConfig(seed=0)``, at the smoke
config's bf16 activations through the reference's ``train(
"deepseek-v2-lite-16b", True, 3, 8, 32, None, model_axis=2)``, and in f32
activations. At ``moe_data_shards = 1`` (the smoke config's, and what the
reference's ``train()`` runs) the reference routes all 256 tokens of a
step in one capacity grid, and so does every rank of the port
(``tests/test_torch_mesh_moe_groups.py`` has ``moe_data_shards = 2``).

Serving (TP, the ``serve`` rules, f32 activations): prefill of a 2 x 16
prompt (MLA's dense path, the latent cache ``ckv`` sharded along the
sequence over "model", ``krope`` replicated) and one absorbed decode step.

Bars (``tests/torch_mesh_ref.py``): f32 losses 1e-5 relative, bf16 2^-9;
logits and caches 2e-4; the next token equal; every rank's parameters after
the steps equal bit for bit; the f32 first-step gradient 1e-4 of each leaf's
max.

Cut for the time limit: three steps.
"""
import pytest

import torch_mesh_ref as ref

ARCH = "deepseek-v2-lite-16b"
TRAIN = ((ARCH, "bfloat16", 1), (ARCH, "float32", 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_deepseek"), train=TRAIN,
                   serve=((ARCH, 1),))


def test_reference_trains_from_the_weights_the_port_was_given(runs):
    assert runs[1]["same_weights"] == {ARCH: True}


@pytest.mark.parametrize("job", TRAIN, ids=lambda j: j[1])
def test_fsdp_tp_train_matches_reference(runs, job):
    ref.check_train(runs, job)


def test_tp_prefill_and_absorbed_decode_match_reference(runs):
    ref.check_serve(runs, (ARCH, 1, False))
