"""The port's H100 roofline (``repro_torch.launch.roofline``) and mesh
helpers against the reference's: ``analytic_hbm_bytes`` and
``model_flops_estimate`` equal for every architecture at full width and
every step kind (decode on the port's cache shapes), the roofline terms
computed from the card table by the reference's formulas,
``elastic_mesh_shape`` equal, ``chip_smoke.py``'s rates read from the
table, and the collective bytes of one sharded matmul and one FSDP
all-gather on a 2 x 2 gloo mesh (four spawned ranks,
``tests/torch_mesh_worker.py``) equal to a hand count.
"""
import dataclasses
import importlib.util
import os

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro.launch.mesh import elastic_mesh_shape as ref_elastic
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import elastic_mesh_shape
from torch_mesh_worker import collective_rank, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_and_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pbytes = 2 * cfg.param_count()
    for name in STEPS:
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        assert roofline.model_flops_estimate(cfg, shape) == \
            ref_roofline.model_flops_estimate(rcfg, rshape)
        for chips, shards in ((1, None), (4, 2), (256, 16)):
            kw = dict(chips=chips, param_bytes=pbytes, opt_bytes=4 * pbytes,
                      param_shards=shards)
            assert roofline.analytic_hbm_bytes(cfg, shape, **kw) == \
                ref_roofline.analytic_hbm_bytes(rcfg, rshape, **kw), \
                (arch, name, chips)


def test_fp8_cache_decode_bytes_equal_the_reference():
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              kv_dtype="float8_e4m3fn")
    rcfg = dataclasses.replace(ref_get_config("qwen2-0.5b"),
                               kv_dtype="float8_e4m3fn")
    kw = dict(chips=8, param_bytes=10 ** 9)
    assert roofline.analytic_hbm_bytes(cfg, SHAPES["decode_32k"], **kw) == \
        ref_roofline.analytic_hbm_bytes(rcfg, REF_SHAPES["decode_32k"], **kw)


@pytest.mark.parametrize("name, key", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL"), ("", "H100")])
def test_roofline_terms_from_the_card_table(name, key):
    c = roofline.card(name)
    assert c is roofline.CARDS[key]
    fields = dict(arch="qwen2-0.5b", shape="train_4k", mesh="2x2", chips=4,
                  flops=3.1e14, bytes_accessed=2.2e11, coll_bytes=9.0e10,
                  coll_breakdown={"all-gather": 9 * 10 ** 10},
                  model_flops=1.0e15)
    port = roofline.Roofline.on(c, **fields)
    ref = ref_roofline.Roofline(peak_flops=c.bf16_flops, hbm_bw=c.hbm_bw,
                                ici_bw=c.nvlink_bw, **fields)
    assert port.row() == ref.row()
    assert port.t_compute == fields["flops"] / c.bf16_flops
    assert port.t_memory == fields["bytes_accessed"] / c.hbm_bw
    assert port.t_collective == fields["coll_bytes"] / c.nvlink_bw
    assert port.t_bound == max(port.t_compute, port.t_memory,
                               port.t_collective)


@pytest.mark.parametrize("compute, attr", [
    ("bf16", "bf16_flops"), ("tf32", "tf32_flops"), ("f32", "f32_flops")])
def test_roofline_peak_follows_the_compute_dtype(compute, attr):
    """An f32 step on the CUDA cores is bound by the f32 rate, not bf16's."""
    c = roofline.CARDS["H100"]
    r = roofline.Roofline.on(c, compute, arch="qwen2-0.5b", shape="prefill",
                             mesh="4", chips=4, flops=6.7e12,
                             bytes_accessed=1e9, coll_bytes=0.0,
                             coll_breakdown={}, model_flops=2.7e13)
    assert r.peak_flops == getattr(c, attr)
    assert r.t_compute == 6.7e12 / getattr(c, attr)
    with pytest.raises(KeyError):
        roofline.Roofline.on(c, "fp8", arch="a", shape="s", mesh="1",
                             chips=1, flops=1.0, bytes_accessed=1.0,
                             coll_bytes=0.0, coll_breakdown={},
                             model_flops=1.0)


def test_card_table_is_the_data_sheets_and_the_smokes():
    sxm = roofline.CARDS["H100"]
    assert (sxm.hbm_bw, sxm.f32_flops, sxm.bf16_flops, sxm.tf32_flops,
            sxm.nvlink_bw) == (3.35e12, 67e12, 989e12, 494.7e12, 450e9)
    assert roofline.PEAK_FLOPS == sxm.bf16_flops
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                 "NVIDIA H100 NVL"):
        c = roofline.card(name)
        assert smoke.card_rates(name) == (c.hbm_bw, c.f32_flops,
                                          c.bf16_flops, c.tf32_flops)


@pytest.mark.parametrize("n, m", [(256, 16), (255, 16), (96, 16), (7, 4),
                                  (1, 16), (48, 8), (512, 16)])
def test_elastic_mesh_shape_equals_the_reference(n, m):
    assert elastic_mesh_shape(n, m) == ref_elastic(n, m)


def test_collective_bytes_equal_a_hand_count():
    """x (8, 64) f32 sharded ("data", "model") times w (64, 32) sharded
    ("model", None): each rank multiplies its (4, 32) x (32, 32) blocks into
    a partial (4, 32) sum, and the one all-reduce over "model" moves its
    4 * 32 * 4 = 512 bytes. A (64, 32) f32 weight sharded over "data" made
    whole: one all-gather of the local (32, 32) shard, 4,096 bytes."""
    got = run_ranks(collective_rank, 4, 2)
    zero = dict.fromkeys(roofline.COLLECTIVES, 0)
    for (mm, mm_calls), (ag, ag_calls), ok in got:
        assert ok
        assert mm == {**zero, "all-reduce": 512}
        assert mm_calls == {**zero, "all-reduce": 1}
        assert ag == {**zero, "all-gather": 4096}
        assert ag_calls == {**zero, "all-gather": 1}
