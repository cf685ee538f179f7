"""Port parity: the paper's technique on tensors (hotspot detection, group
apply, the segment-sum kernel's plain version and the grouped scatter-apply)
against the JAX reference, at the reference tests' cases and tolerances."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import (group_apply as ref_group_apply,
                        hotspot_apply as ref_hotspot_apply,
                        scatter_serial as ref_scatter_serial,
                        form_groups as ref_form_groups,
                        update_hotspot as ref_update_hotspot,
                        init_hotspot as ref_init_hotspot)
from repro.kernels.grouped_scatter import (
    segment_sums as ref_segment_sums,
    grouped_scatter_apply as ref_grouped_scatter_apply,
    grouped_apply_ref as ref_grouped_apply_ref)
from repro_torch.core import (group_apply, hotspot_apply, scatter_serial,
                              form_groups, detect_hot, init_hotspot,
                              update_hotspot, DependencyList,
                              DependencyError)
from repro_torch.kernels.grouped_scatter import (
    segment_sums, grouped_scatter_apply, grouped_apply_ref)
from repro_torch.kernels.grouped_scatter import kernel

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- segment_sums: plain version vs the Pallas kernel (interpret mode) ---

@pytest.mark.parametrize("n,d,g", [(64, 8, 4), (700, 130, 37),
                                   (1024, 256, 1), (33, 7, 33),
                                   (512, 64, 100)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_sums_sweep(n, d, g, dtype):
    rng = np.random.default_rng(n * 7 + d + g)
    seg = np.sort(rng.integers(0, g, n)).astype(np.int32)
    upd = rng.normal(size=(n, d)).astype(dtype)
    want = np.asarray(ref_segment_sums(jnp.asarray(seg), jnp.asarray(upd), g))
    got = segment_sums(T(seg), T(upd), g)
    assert got.dtype == torch.float32 and got.shape == (g, d)
    tol = 2e-4 if dtype == np.float32 else 2e-2    # test_kernels.py:29
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_segment_sums_unsorted_ids():
    rng = np.random.default_rng(9)
    seg = rng.integers(0, 9, 200).astype(np.int32)
    upd = rng.normal(size=(200, 16)).astype(np.float32)
    want = np.asarray(ref_segment_sums(jnp.asarray(seg), jnp.asarray(upd), 9))
    np.testing.assert_allclose(segment_sums(T(seg), T(upd), 9).numpy(), want,
                               rtol=1e-5, atol=1e-5)   # test_kernels.py:35


def test_segment_sums_out_of_range_ids_dropped():
    seg = T(np.array([-1, 0, 0, 2, -1, 3, 7], np.int32))
    got = segment_sums(seg, torch.ones((7, 4)), 3)
    np.testing.assert_allclose(got[:, 0].numpy(), [2, 0, 1])


# --- grouped_scatter_apply (end to end) ---

@pytest.mark.parametrize("hotness", [0, 200, 1800])
def test_grouped_scatter_apply_matches_reference(hotness):
    rng = np.random.default_rng(hotness)
    V, N, D = 300, 2048, 32
    ids = rng.integers(0, V, N).astype(np.int32)
    if hotness:
        ids[:hotness] = 5
    upd = rng.normal(size=(N, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    want = np.asarray(ref_grouped_scatter_apply(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd), threshold=32))
    got = grouped_scatter_apply(T(table), T(ids), T(upd), threshold=32,
                                device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    oracle = grouped_apply_ref(T(table), T(ids), T(upd))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_over_max_hot_rows_keep_their_updates():
    """Ten rows with 40 updates each, threshold 32, max_hot 4: the six hot
    rows beyond max_hot go through the cold scatter instead of being lost
    (the reference drops them), so the result equals the 2PL oracle."""
    rng = np.random.default_rng(0)
    V, N, D = 300, 2048, 8
    ids = rng.integers(10, V, N).astype(np.int32)
    ids[:400] = np.repeat(np.arange(10, dtype=np.int32), 40)
    upd = np.ones((N, D), np.float32)
    table = np.zeros((V, D), np.float32)
    got = grouped_scatter_apply(T(table), T(ids), T(upd), threshold=32,
                                max_hot=4, device="cpu").numpy()
    want = np.asarray(ref_grouped_apply_ref(jnp.asarray(table),
                                            jnp.asarray(ids),
                                            jnp.asarray(upd)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[:10, 0], 40.0)
    # with max_hot covering every hot row the port equals the reference's
    # own output too
    ref = np.asarray(ref_grouped_scatter_apply(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        threshold=32, max_hot=16))
    got16 = grouped_scatter_apply(T(table), T(ids), T(upd), threshold=32,
                                  max_hot=16, device="cpu").numpy()
    np.testing.assert_allclose(got16, ref, rtol=1e-4, atol=1e-4)


# --- core.group_apply / core.hotspot ---

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n,v,d", [(300, 64, 9), (57, 5, 1), (200, 32, 4)])
def test_group_apply_matches_reference(n, v, d, seed):
    rng = np.random.default_rng(100 * n + seed)
    ids = rng.integers(0, v, n).astype(np.int32)
    n_hot = int(n * rng.uniform(0.0, 0.9))
    if n_hot:
        ids[:n_hot] = rng.integers(0, v)
    upd = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    jt, ji, ju = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)
    tt, ti, tu = T(table), T(ids), T(upd)
    pairs = [
        (ref_scatter_serial(jt, ji, ju), scatter_serial(tt, ti, tu, "cpu")),
        (ref_group_apply(jt, ji, ju), group_apply(tt, ti, tu, "cpu")),
        (ref_hotspot_apply(jt, ji, ju, threshold=8),
         hotspot_apply(tt, ti, tu, threshold=8, device="cpu")),
    ]
    for want, got in pairs:           # test_group_apply.py: 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    rg, pg = ref_form_groups(ji), form_groups(ti)
    for f in ("order", "sorted_ids", "is_leader", "group_size"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(rg, f)), err_msg=f)


def test_hotspot_detector_matches_reference():
    ids = np.concatenate([np.zeros(40, np.int32),
                          np.arange(1, 11, dtype=np.int32)])
    hot = detect_hot(T(ids), 16, threshold=32)
    assert bool(hot[0]) and not bool(hot[1:].any())
    ps, rs = init_hotspot(16, "cpu"), ref_init_hotspot(16)
    ps = update_hotspot(ps, T(ids), threshold=32)
    rs = ref_update_hotspot(rs, jnp.asarray(ids), threshold=32)
    assert bool(ps.hot[0])
    cold = np.arange(1, 11, dtype=np.int32)
    for _ in range(40):               # the sweeper demotes as the EMA decays
        ps = update_hotspot(ps, T(cold), threshold=32)
        rs = ref_update_hotspot(rs, jnp.asarray(cold), threshold=32)
        np.testing.assert_array_equal(ps.hot.numpy(), np.asarray(rs.hot))
        np.testing.assert_allclose(ps.ema.numpy(), np.asarray(rs.ema),
                                   rtol=1e-6, atol=0)
    assert not bool(ps.hot[0])
    assert int(ps.step) == int(rs.step) == 41


def test_dependency_list_orders():
    dl = DependencyList()
    a, b, c = dl.assign(), dl.assign(), dl.assign()
    with pytest.raises(DependencyError):
        dl.commit(b)
    with pytest.raises(DependencyError):
        dl.rollback(a)
    dl.commit(a)
    assert dl.rollback_all_from(b) == [c, b]
    assert dl.recover([3, 7, 5]) == [7, 5, 3] and dl.assign() == 8


# --- the CUDA kernel's algorithm, modelled in numpy ---

def _kernel_model(seg, upd, G, n_sms=132):
    """The five launches of ``csrc/segment_sums.cu`` step by step in numpy
    at the wrapper's launch plan: chunked counting sort (histogram, scan,
    stable scatter), per-block f64 runs with head/tail spill, combine."""
    N, D = upd.shape
    n_chunks, chunk, n_blocks, rb = kernel.launch_plan(N, D, n_sms)
    assert n_chunks * chunk >= N and n_blocks * rb >= N
    valid = (seg >= 0) & (seg < G)
    counts = np.zeros((n_chunks, G), np.int64)
    for c in range(n_chunks):
        s = seg[c * chunk:(c + 1) * chunk]
        np.add.at(counts[c], s[(s >= 0) & (s < G)], 1)
    offs = np.cumsum(counts, axis=0) - counts        # scan_kernel, part 1
    total = counts.sum(axis=0)
    gstart = np.concatenate([[0], np.cumsum(total)])  # part 2
    perm = np.full(N, -1)
    sg = np.full(N, -1)
    for c in range(n_chunks):                          # scatter_kernel
        placed = np.zeros(G, np.int64)
        for n in range(c * chunk, min(N, (c + 1) * chunk)):
            if valid[n]:
                g = seg[n]
                pos = gstart[g] + offs[c, g] + placed[g]
                perm[pos], sg[pos] = n, g
                placed[g] += 1
    n_valid = gstart[G]
    out = np.full((G, D), np.nan)
    head = np.full((n_blocks, D), np.nan)
    tail = np.full((n_blocks, D), np.nan)
    for b in range(n_blocks):                          # reduce_sorted_kernel
        p0, p1 = b * rb, min(n_valid, (b + 1) * rb)
        if p0 >= p1:
            continue
        gf, gl = sg[p0], sg[p1 - 1]
        for g in np.unique(sg[p0:p1]):
            run = upd[perm[p0:p1][sg[p0:p1] == g]].astype(np.float64).sum(0)
            if g == gf and gstart[g] < p0:
                head[b] = run
            elif g == gl and gstart[g + 1] > p1:
                tail[b] = run
            else:
                out[g] = run
    for g in range(G):                                 # combine_kernel
        s, e = gstart[g], gstart[g + 1]
        if s == e:
            out[g] = 0.0
        elif s // rb != (e - 1) // rb:
            b0, b1 = s // rb, (e - 1) // rb
            out[g] = tail[b0] + head[b0 + 1:b1 + 1].sum(0)
    # the sort is stable and complete
    assert sorted(perm[:n_valid]) == list(np.nonzero(valid)[0])
    for g in range(G):
        rows = perm[gstart[g]:gstart[g + 1]]
        assert (np.diff(rows) > 0).all() and (seg[rows] == g).all()
    return out.astype(np.float32)


@pytest.mark.parametrize("n,d,g,hot", [(3000, 8, 5, 0.9), (700, 130, 37, 0.0),
                                       (5000, 3, 300, 0.5), (33, 7, 33, 0.0),
                                       (1, 1, 1, 0.0)])
def test_kernel_algorithm_model(n, d, g, hot):
    """The kernel's sort/reduce/spill/combine rules give the f64 sums
    (every group written once, spanning groups combined); the hot group
    spans many reduce blocks."""
    rng = np.random.default_rng(n + g)
    seg = rng.integers(-1, g + 1, n).astype(np.int32)
    seg[:int(n * hot)] = 0                 # a group spanning many blocks
    upd = rng.normal(size=(n, d)).astype(np.float32)
    want = segment_sums(T(seg), T(upd), g).numpy()
    for n_sms in (132, 1):
        np.testing.assert_allclose(_kernel_model(seg, upd, g, n_sms), want,
                                   rtol=1e-6, atol=1e-6)


def test_launch_plan_covers_rows():
    for N, D in [(262_144, 512), (33, 7), (1024, 256), (0, 4),
                 (10_000, 64)]:
        n_chunks, chunk, n_blocks, rb = kernel.launch_plan(N, D, 132)
        assert 1 <= n_chunks <= kernel.SORT_CHUNKS_MAX
        assert n_chunks * chunk >= N and n_blocks * rb >= N
        assert n_blocks * -(-D // kernel.BD) <= max(
            132 * kernel.BLOCKS_PER_SM + -(-D // kernel.BD), 1)
