"""Port parity: the engine's inputs (workload generator, hash, Zipf table,
chop tables) in ``repro_torch`` equal the JAX reference bit for bit."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.lock import chop as ref_chop, workload as ref_wl
from repro_torch.core.lock import chop, workload as wl

KINDS = ["hotspot_update", "hotspot_mix", "hotspot_scan", "uniform",
         "zipf", "fit", "tpcc"]
T, L, R = 64, 5, 300


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(kind, **kw):
    base = dict(kind=kind, n_rows=R, txn_len=4, write_ratio=0.6, n_hot=3,
                n_warehouses=2, seed=5, zipf_s=0.9)
    base.update(kw)
    return ref_wl.WorkloadSpec(**base), wl.WorkloadSpec(**base)


@pytest.mark.parametrize("hot_base", [0, 37])
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_gen_txn_bit_equal(kind, ordered, hot_base):
    rspec, pspec = _specs(kind, hot_base=hot_base)
    rng = np.random.default_rng(
        KINDS.index(kind) * 4 + 2 * ordered + hot_base)
    tids = np.arange(T, dtype=np.int32)
    ctr = rng.integers(0, 2**31 - 1, T).astype(np.int32)
    want = ref_wl.gen_txn_dyn(kind, R, L, ref_wl.dyn_workload(rspec),
                              jnp.asarray(tids), jnp.asarray(ctr),
                              acq_order=jnp.asarray(ordered))
    got = wl.gen_txn_dyn(kind, R, L, wl.dyn_workload(pspec, "cpu"),
                         torch.from_numpy(tids), torch.from_numpy(ctr),
                         acq_order=ordered)
    for name, a, b in zip(("keys", "iswr", "dup", "lastu", "nops"),
                          want, got):
        a = np.array(a)
        assert b.dtype == torch.from_numpy(a).dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def test_reads_lock_and_write_ratio_edges():
    for wr, rl in [(0.0, True), (1.0, False), (0.3, False)]:
        rspec, pspec = _specs("uniform", write_ratio=wr, reads_lock=rl)
        tids = np.arange(T, dtype=np.int32)
        ctr = np.full(T, 7, np.int32)
        want = ref_wl.gen_txn_dyn("uniform", R, L, ref_wl.dyn_workload(rspec),
                                  jnp.asarray(tids), jnp.asarray(ctr))
        got = wl.gen_txn_dyn("uniform", R, L, wl.dyn_workload(pspec, "cpu"),
                             torch.from_numpy(tids), torch.from_numpy(ctr))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", [0, 3, -2])
def test_will_abort_bit_equal(seed):
    tids = np.arange(T, dtype=np.int32)
    ctr = np.random.default_rng(seed + 10).integers(
        0, 2**31 - 1, T).astype(np.int32)
    for p in (0.0, 0.05, 0.5, 1.0):
        want = ref_wl.will_abort_dyn(jnp.int32(seed), jnp.float32(p),
                                     jnp.asarray(tids), jnp.asarray(ctr))
        got = wl.will_abort_dyn(seed, float(np.float32(p)),
                                torch.from_numpy(tids), torch.from_numpy(ctr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_gen_txn_static_wrapper_bit_equal(kind):
    """``gen_txn(spec, ...)``, the static-spec wrapper, against the
    reference's: the spec's own ``txn_len`` and tables."""
    rspec, pspec = _specs(kind, hot_base=11)
    tids = np.arange(T, dtype=np.int32)
    ctr = np.random.default_rng(KINDS.index(kind) + 50).integers(
        0, 2**31 - 1, T).astype(np.int32)
    want = ref_wl.gen_txn(rspec, jnp.asarray(tids), jnp.asarray(ctr))
    got = wl.gen_txn(pspec, torch.from_numpy(tids), torch.from_numpy(ctr))
    for name, a, b in zip(("keys", "iswr", "dup", "lastu", "nops"),
                          want, got):
        a = np.array(a)
        assert b.dtype == torch.from_numpy(a).dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("p", [-0.5, 0.0, 1e-9, 0.05, 0.5, 1.0])
def test_will_abort_static_wrapper_bit_equal(p):
    """``will_abort(spec, p, ...)`` against the reference's, all false at
    ``p <= 0`` (where no hash is drawn)."""
    rspec, pspec = _specs("zipf", seed=9)
    tids = np.arange(T, dtype=np.int32)
    ctr = np.random.default_rng(77).integers(0, 2**31 - 1,
                                             T).astype(np.int32)
    want = np.asarray(ref_wl.will_abort(rspec, p, jnp.asarray(tids),
                                        jnp.asarray(ctr)))
    got = wl.will_abort(pspec, p, torch.from_numpy(tids),
                        torch.from_numpy(ctr))
    assert got.dtype == torch.bool and want.dtype == np.bool_
    np.testing.assert_array_equal(got.numpy(), want)
    if p <= 0:
        assert not got.any()
    if p == 0.5:
        assert 0 < int(got.sum()) < T


def _u32_edges():
    top = np.arange(0xFFFFFF00, 0x100000000, dtype=np.uint64)
    mid = np.arange(2**24 - 300, 2**24 + 300, dtype=np.uint64)
    low = np.arange(0, 300, dtype=np.uint64)
    rnd = np.random.default_rng(1).integers(0, 2**32, 4000, dtype=np.uint64)
    return np.concatenate([top, mid, low, rnd, [2**31 - 1, 2**31]])


def test_uniform01_u32_edges():
    """u32 -> f32 rounds to nearest: values >= 0xFFFFFF80 become 2**32 and
    give u == 1.0 in both packages."""
    h = _u32_edges()
    want = np.asarray(ref_wl._uniform01(jnp.asarray(h.astype(np.uint32))))
    got = wl._uniform01(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[h >= 0xFFFFFF80] == 1.0).all()


def test_hash_u32_edges():
    h = _u32_edges()
    want = np.asarray(ref_wl._hash_u32(jnp.asarray(h.astype(np.uint32))))
    got = wl._hash_u32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    a = h.astype(np.uint32).view(np.int32)
    b = np.roll(a, 1)
    want3 = np.asarray(ref_wl._hash3(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(b[::-1].copy()), 12345))
    got3 = wl._hash3(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(b[::-1].copy()), 12345).numpy()
    np.testing.assert_array_equal(got3, want3.astype(np.int64))


@pytest.mark.parametrize("s", [0.0, 0.7, 1.2])
def test_zipf_table_equal(s):
    want = np.asarray(ref_wl.zipf_cdf_table(5000, s))
    got = wl.zipf_cdf_table(5000, s, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_chop_tables_equal(kind):
    for hb in (0, 21):
        rspec, pspec = _specs(kind, hot_base=hb, n_rows=64)
        np.testing.assert_array_equal(chop.acquisition_rank(pspec),
                                      np.asarray(
                                          ref_chop.acquisition_rank(rspec)))
        assert chop.chop(pspec).describe() == ref_chop.chop(rspec).describe()


def test_chop_helpers_equal():
    rng = np.random.default_rng(4)
    rank = rng.permutation(50).astype(np.int32)
    keys = rng.integers(0, 6, (40, 6)).astype(np.int32)
    iswr = rng.random((40, 6)) < 0.5
    nops = rng.integers(1, 7, 40).astype(np.int32)
    for txn_len in (1, 4, 6):
        want = ref_chop.apply_acquisition_order(
            jnp.asarray(rank), jnp.asarray(keys), jnp.asarray(iswr),
            jnp.int32(txn_len), jnp.asarray(True))
        got = chop.apply_acquisition_order(
            torch.from_numpy(rank), torch.from_numpy(keys),
            torch.from_numpy(iswr), txn_len)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        chop.last_use(torch.from_numpy(keys), torch.from_numpy(nops)).numpy(),
        np.asarray(ref_chop.last_use(jnp.asarray(keys), jnp.asarray(nops))))


def test_drift_schedules_equal():
    rspec, pspec = _specs("hotspot_mix", n_rows=1000)
    for name in ("hot_migration", "skew_ramp", "flash_crowd"):
        a = getattr(ref_wl, name)(rspec, 6)
        b = getattr(wl, name)(pspec, 6)
        assert [dataclasses.asdict(x) for x in a.specs] == \
            [dataclasses.asdict(x) for x in b.specs]
