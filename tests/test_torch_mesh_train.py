"""FSDP+TP training of the port on a 2 x 2 mesh of four gloo ranks (spawned
processes, ``tests/torch_mesh_worker.py``) against the reference's
``repro.launch.train.train("qwen2-0.5b", True, 3, 8, 32, None,
model_axis=2)`` on four forced host devices (one subprocess for the file,
``tests/torch_mesh_ref.py``; its mesh is ``make_host_mesh(2)``'s), on the
same weights (the reference's ``init_params`` at ``PRNGKey(0)``) and
batches (its ``make_batch`` from ``DataConfig(seed=0)``).

Bars (``tests/torch_mesh_ref.py::check_train``). In f32 activations (both
packages' train loop rerun with ``act_dtype="float32"``) the losses agree
within 1e-5 relative, the loss bar of ``tests/torch_train_parity.py``, and
every rank's gradient of the first step (``value_and_grad``) lies within
1e-4 of each leaf's max of the reference's ``jax.grad`` on its mesh: the
three steps lie inside AdamW's warmup, where a wrong gradient moves a loss
by less than the loss bar. At the smoke config's bf16 activations the
reference's own losses are 6.104712, 6.094141 and 6.090685; the port's
sharded ones agree within 2^-9 relative, one rounding of a bf16 value
(8 significant bits): the two packages round their bf16 activations in
different orders, so the bf16 losses are held to bf16's own resolution.
In both, every rank's parameters after the steps equal rank 0's bit for
bit.

Cut for the time limit: three steps.
"""
import numpy as np
import pytest

import torch_mesh_ref as ref

ARCH = "qwen2-0.5b"
REF_LOSSES = [6.104712, 6.094141, 6.090685]
TRAIN = ((ARCH, "bfloat16", 1), (ARCH, "float32", 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the reference's subprocess, run once for the
    file: (every rank's results, the reference's)."""
    return ref.run(tmp_path_factory.mktemp("mesh_train"), train=TRAIN)


def test_reference_reproduces_its_sharded_train(runs):
    """The reference's train(model_axis=2) on its own mesh, from the weights
    this test carried over to the port."""
    want = runs[1]
    assert want["same_weights"] == {ARCH: True}
    assert want["train"][TRAIN[0]] == pytest.approx(REF_LOSSES, abs=5e-7)


def test_every_rank_reports_the_same_losses(runs):
    for job in TRAIN:
        got = [rank["train"][job]["losses"] for rank in runs[0]]
        assert all(g == got[0] for g in got)


@pytest.mark.parametrize("act, tol", [("float32", ref.F32_TOL),
                                      ("bfloat16", ref.BF16_TOL)])
def test_fsdp_tp_train_matches_reference(runs, act, tol):
    got, want = runs
    job = (ARCH, act, 1)
    np.testing.assert_allclose(got[0]["train"][job]["losses"],
                               want["train"][job], rtol=tol)
    ref.check_train(runs, job)
