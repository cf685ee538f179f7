"""``train(model_axis=2)`` of the port on four gloo ranks (spawned processes,
``tests/torch_mesh_worker.py``): a 2 x 2 FSDP+TP mesh at qwen2-0.5b's smoke
config (B = 8, S = 32). A restart from the sharded checkpoint repeats the
uninterrupted run's losses and final parameters bit for bit on every rank,
every rank holds the same parameters after the last step, bit for bit (as
``tests/torch_mesh_ref.py::check_train`` holds the sharded train jobs; the
first step's gradient of these weights and batch, in f32, is held to the
reference's in ``tests/test_torch_mesh_train.py``), and the sharded losses
agree with the one-device ``train()``'s within 2^-9 relative (one bf16
rounding: the smoke config's activations are bf16, and the mesh sums its
shards' partial products in another order). Without a process group a
sharded entry point raises instead of running on one device.

Cut for the time limit: four steps (steps 1-4 lie in AdamW's warmup, where
``decay_steps``, set from ``steps``, plays no part).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train
from torch_mesh_worker import restart_rank, run_ranks

BF16_TOL = 2.0 ** -9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_restart_repeats_losses_bit_for_bit(tmp_path):
    got = run_ranks(restart_rank, 4, str(tmp_path), 2)
    full, first, rest, p_full, p_rest = got[0]
    assert all(g[:3] == got[0][:3] for g in got), "every rank, one loss"
    assert len(full) == 4 and first == full[:2] and rest == full[2:]
    want = jax.tree.leaves(p_full)
    for g in got:
        for params in g[3:]:        # every rank, straight and resumed
            ps = jax.tree.leaves(params)
            assert len(ps) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(ps, want))
    one = train("qwen2-0.5b", True, 4, 8, 32, None, device="cpu",
                log_every=100)
    np.testing.assert_allclose(full, one, rtol=BF16_TOL)


def test_sharded_entry_points_need_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2)
    with pytest.raises(ValueError, match="model_axis=2.*process group"):
        train("qwen2-0.5b", True, 1, 2, 16, None, model_axis=2, device="cpu")
