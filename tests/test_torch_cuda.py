"""Port checks that need the NVIDIA card (marker ``cuda``): the CUDA kernel
against its plain version, and the engine on the card against its CPU run.
This file imports no JAX, so it also runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lock import (EngineConfig, WorkloadSpec, CostModel,
                                   protocol_params, run_sim)
from repro_torch.core.lock.convert import state_to_numpy
from repro_torch.kernels.grouped_scatter import (segment_sums,
                                                 segment_sums_ref)

PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "and the check compares the card with the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,g,dtype,tol", [
    (700, 130, 37, np.float32, 2e-4),        # test_kernels.py:29 tolerances
    (512, 64, 100, np.float16, 2e-2),
    (20_000, 512, 256, np.float32, 2e-4),
    (33, 7, 300, np.float32, 2e-4),
    (50_000, 64, 8, np.float32, 2e-4),       # one group spans many blocks
])
def test_segment_sums_kernel_on_card(card, n, d, g, dtype, tol):
    rng = np.random.default_rng(n + g)
    ids = rng.integers(-1, g + 1, n).astype(np.int32)
    ids[: n * 4 // 5 if g == 8 else 0] = 0
    seg = torch.from_numpy(ids)
    upd = torch.from_numpy(rng.normal(size=(n, d)).astype(dtype))
    seg, upd = seg.cuda(), upd.cuda()
    before = segment_sums.launches
    got = segment_sums(seg, upd, g)
    assert segment_sums.launches == before + 1
    torch.testing.assert_close(got, segment_sums_ref(seg, upd, g),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("proto", PROTOS)
def test_engine_on_card_equals_cpu(card, proto):
    cfg = EngineConfig(
        protocol=protocol_params(proto), costs=CostModel(),
        workload=WorkloadSpec(kind="tpcc", n_rows=256, txn_len=3,
                              n_warehouses=2, write_ratio=0.7),
        n_threads=40, horizon=4_000, p_abort=0.05, attrib=True)
    a = state_to_numpy(run_sim(cfg, device="cuda"))
    b = state_to_numpy(run_sim(cfg, device="cpu"))
    for part in ("th", "rows", "g"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{f}")
