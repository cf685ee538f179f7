"""The MoE layer's capacity grids on a 2 x 2 mesh of four gloo ranks
(spawned processes, ``tests/torch_mesh_worker.py``) against the reference
on four forced host devices (one subprocess for the file,
``tests/torch_mesh_ref.py``).

deepseek-v2-lite-16b at its smoke config with ``moe_data_shards = 2`` (one
capacity grid a data shard, the grids sharded over "data"): three FSDP+TP
steps of 8 x 32 in f32 from the reference's weights and batches, and a TP
prefill of a 2 x 16 prompt + one decode step (f32). Then the layer alone:
``moe`` on the mesh (weights by the ``train`` rules, 4 x 32 tokens over
"data", numpy inputs) at capacity factor 0.5, so that assignments drop,
for deepseek-v2-lite-16b (shared expert) and arctic-480b at
``moe_data_shards`` 1 and 2: output, aux loss, ``MoEStats`` and the
gradients of ``sum(y * w) + 3 aux`` with respect to every weight and the
tokens, against the reference's ``jax.value_and_grad`` of its ``moe`` on
its mesh.

Bars (``tests/torch_mesh_ref.py``): f32 losses 1e-5 relative; logits and
caches 2e-4; the next token equal; the layer's output, aux and gradients
1e-5 of their max, counts and drops equal, the routed weights' gradients in
their weights' placements; every rank's parameters after the steps equal bit
for bit; the f32 first-step gradient 1e-4 of each leaf's max.

Cut for the time limit: three steps, f32 only at ``ds = 2``.
"""
import pytest

import torch_mesh_ref as ref

ARCH = "deepseek-v2-lite-16b"
MOE = ((ARCH, 1, 0.5), (ARCH, 2, 0.5), ("arctic-480b", 1, 0.5),
       ("arctic-480b", 2, 0.5))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run(tmp_path_factory.mktemp("mesh_groups"),
                   train=((ARCH, "float32", 2),), serve=((ARCH, 2),),
                   moe=MOE)


def test_reference_trains_from_the_weights_the_port_was_given(runs):
    assert runs[1]["same_weights"] == {ARCH: True}


def test_fsdp_tp_train_per_data_shard_grids_matches_reference(runs):
    ref.check_train(runs, (ARCH, "float32", 2))


def test_tp_prefill_and_decode_per_data_shard_grids_match_reference(runs):
    ref.check_serve(runs, (ARCH, 2, False))


@pytest.mark.parametrize("case", MOE, ids=lambda c: f"{c[0]}-ds{c[1]}")
def test_moe_layer_and_stats_match_reference(runs, case):
    ref.check_moe(runs, case)
