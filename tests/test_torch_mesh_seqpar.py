"""The sequence-parallel residual of the port on a 2 x 2 mesh of four gloo
ranks (spawned processes, ``tests/torch_mesh_worker.py::seqpar_rank``)
against the reference on four forced host devices (one subprocess for the
file, ``tests/torch_mesh_ref.py``), qwen2-0.5b's smoke config from the
reference's weights (``init_params`` at ``PRNGKey(0)``).

The reference annotates the residual ``("batch", "model", None)`` at
every unit boundary (``src/repro/models/transformer.py:163``) and after the
embedding (``src/repro/models/lm.py:46``): sharded over the data axes along
the batch and over "model" along the sequence, where the model axis divides
the sequence. Here the residual each unit's remat checkpoint keeps (f32
activations, ``remat`` on, chunked CE at ``LOSS_CHUNK``: one train batch of
8 x 32 through ``value_and_grad``) is each rank's (B/2, S/2, d) shard, its
placements the spec that the reference's own ``annotate`` gives that shape
on its mesh; so is each block's input in a prefill of 2 x 16. A prefill of
15 positions and the decode step (S = 1) keep the sequence whole, as the
reference's rule does where the axis does not divide it.

Bars (the mesh files', ``tests/torch_mesh_ref.py``): the f32 loss within 1e-5
relative; the prefill's last-token logits and the caches within 2e-4, the
next token equal. The collectives of one FSDP+TP step (smoke config, B = 8,
S = 32) of qwen2-0.5b and deepseek-v2-lite-16b stay within 1.05 times the
bytes a rank that the batch-sharded residual moved, so that no later change
gathers the whole residual unnoticed.
"""
import numpy as np
import pytest

import torch_mesh_ref as ref
from torch_mesh_worker import seqpar_rank

ARCH = "qwen2-0.5b"
D_MODEL = 64                       # the smoke config's
LOSS_CHUNK = 8
# (B, S, d) of the train batch, the prompt, the odd prompt and a decode step
TRAIN_SHAPE = (ref.B, ref.S, D_MODEL)
PROMPT = (ref.SERVE_B, ref.SERVE_S, D_MODEL)
ODD = (ref.SERVE_B, ref.SERVE_S - 1, D_MODEL)
DECODE = (ref.SERVE_B, 1, D_MODEL)
COLLECTIVE_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")
STEP_SHAPE = (8, 32)
# the bytes a rank that one FSDP+TP step moved (CollectiveCounter, every
# rank alike) while the residual was sharded by batch only: commit 1c029aa
# under tools/step_collectives.py, torch 2.13 on the CPU (all-reduce +
# all-gather + reduce-scatter)
BATCH_ONLY_BYTES = {"qwen2-0.5b": 3_096 + 418_560 + 1_196_032,
                    "deepseek-v2-lite-16b": 319_252 + 586_624 + 1_139_712}
BYTES_MARGIN = 1.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the reference's subprocess, run once for the
    file: (every rank's results, the reference's)."""
    seqpar = {"arch": ARCH, "loss_chunk": LOSS_CHUNK,
              "shapes": [TRAIN_SHAPE, PROMPT, ODD, DECODE],
              "collectives": COLLECTIVE_ARCHS, "step_shape": STEP_SHAPE}
    return ref.run(tmp_path_factory.mktemp("mesh_seqpar"),
                   serve=((ARCH, 1),), seqpar=seqpar, rank_fn=seqpar_rank)


def _halves(shape):
    B, S, d = shape
    return (B // 2, S // 2, d)


def test_reference_shards_the_residual_along_the_sequence(runs):
    specs = runs[1]["seqpar"]["specs"]
    for shape in (TRAIN_SHAPE, PROMPT):
        assert specs[shape] == ("data", "model", None)
    for shape in (ODD, DECODE):
        assert specs[shape] == ("data", None, None)


def test_checkpoint_keeps_each_ranks_sequence_shard(runs):
    """One checkpoint a unit repeat (the smoke config's two layers), each
    keeping the rank's (B/2, S/2, d) shard, placed as the reference's
    annotate places the residual."""
    got, want = runs
    spec = want["seqpar"]["specs"][TRAIN_SHAPE]
    for rank in got:
        saved = rank["saved"]
        assert len(saved) == 2
        for local, placed in saved:
            assert local == _halves(TRAIN_SHAPE)
            assert placed == spec


def test_prefill_residual_is_sequence_parallel(runs):
    got, want = runs
    spec = want["seqpar"]["specs"][PROMPT]
    for rank in got:
        blocks = rank["serve"]["even"]["blocks"]
        pre = [b for b in blocks if b[0] == "prefill"]
        assert len(pre) == 2
        assert all(b[1:] == (_halves(PROMPT), spec) for b in pre)


def test_odd_length_and_decode_keep_the_sequence_whole(runs):
    """Where the model axis does not divide the sequence (15 positions,
    decode's 1) the residual is sharded by batch only, as the reference's
    annotate leaves it."""
    got, want = runs
    specs = want["seqpar"]["specs"]
    for rank in got:
        odd = rank["serve"]["odd"]["blocks"]
        even = rank["serve"]["even"]["blocks"]
        cases = [(ODD, [b for b in odd if b[0] == "prefill"]),
                 (DECODE, [b for b in odd + even if b[0] == "decode"])]
        for shape, blocks in cases:
            assert blocks
            B, S, d = shape
            assert all(b[1:] == ((B // 2, S, d), specs[shape])
                       for b in blocks)


def test_prefill_logits_caches_and_next_token_match_reference(runs):
    got, want = runs
    key = (ARCH, 1, False)
    ref.check_serve(([{"serve": {key: rank["serve"]["even"]}}
                      for rank in got], want), key)


def test_chunked_ce_loss_matches_reference(runs):
    got, want = runs
    losses = [rank["loss"] for rank in got]
    assert all(x == losses[0] for x in losses)
    np.testing.assert_allclose(losses[0], want["seqpar"]["loss"],
                               rtol=ref.F32_TOL)


@pytest.mark.parametrize("arch", COLLECTIVE_ARCHS)
def test_step_collective_bytes_stay_within_the_batch_only_layout(runs,
                                                                 arch):
    for rank in runs[0]:
        per_op, calls = rank["collectives"][arch]
        assert sum(per_op.values()) <= BYTES_MARGIN * BATCH_ONLY_BYTES[arch]
        assert sum(calls.values()) > 0
