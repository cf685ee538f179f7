"""The runtime of the port's training half against the JAX reference: the
data pipeline (deterministic, per host, Zipf skew, shifted labels), the
checkpointer and journal (round trip, async, crash between prepare and
commit, idempotent recovery, gc, bf16 leaves bit for bit, files exchanged
with the reference), failure and straggler planning, sharding plans equal
to the reference's for every architecture, and ``train`` with a restart
equal to the uninterrupted run."""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import (Checkpointer as RefCheckpointer,
                              Journal as RefJournal)
from repro.configs import get_config as ref_get_config
from repro.data import (DataConfig as RefDataConfig,
                        init_state as ref_init_state,
                        make_batch as ref_make_batch)
from repro.distributed import (HeartbeatMonitor as RefHeartbeat,
                               StragglerDetector as RefStraggler,
                               plan_recovery as ref_plan_recovery,
                               rebalance as ref_rebalance,
                               reshard_plan as ref_reshard_plan)
from repro.distributed.sharding import (RULES as REF_RULES,
                                        ResolveReport as RefReport,
                                        _cache_leaf_pspec as ref_cache_spec,
                                        batch_pspec as ref_batch_pspec,
                                        param_pspecs as ref_param_pspecs,
                                        resolve_spec as ref_resolve_spec)
from repro.launch.mesh import elastic_mesh_shape as ref_elastic
from repro.models import lm_spec as ref_lm_spec
from repro.models.transformer import lm_cache_shapes
from repro_torch.checkpoint import Checkpointer, Journal
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, init_state, make_batch
from repro_torch.distributed import (RULES, HeartbeatMonitor, ResolveReport,
                                     StragglerDetector, batch_pspec,
                                     cache_leaf_pspec, cache_pspecs,
                                     elastic_mesh_shape, param_pspecs,
                                     plan_recovery, rebalance, reshard_plan,
                                     resolve_spec)
from repro_torch.launch.train import train
from repro_torch.models import init_params, lm_init_cache, lm_spec
from repro_torch.optim import adamw
from repro_torch.tree import leaves as _leaves

CPU = "cpu"
QWEN = get_config("qwen2-0.5b", smoke=True)


# ------------------------------------------------------------------ data

def test_data_is_deterministic_per_step():
    dc = DataConfig(seed=3)
    b1, s1 = make_batch(dc, QWEN, 4, 32, init_state(), device=CPU)
    b2, _ = make_batch(dc, QWEN, 4, 32, init_state(), device=CPU)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert int(s1.step) == 1
    b3, _ = make_batch(dc, QWEN, 4, 32, s1, device=CPU)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    b4, _ = make_batch(DataConfig(seed=4), QWEN, 4, 32, init_state(),
                       device=CPU)
    assert not torch.equal(b1["tokens"], b4["tokens"])


def test_hosts_get_different_data():
    b1, _ = make_batch(DataConfig(host_id=0), QWEN, 4, 32, init_state(),
                       device=CPU)
    b2, _ = make_batch(DataConfig(host_id=1), QWEN, 4, 32, init_state(),
                       device=CPU)
    assert not torch.equal(b1["tokens"], b2["tokens"])


def test_zipf_skew_matches_the_reference_distribution():
    """Hot rows past the paper's threshold, as the reference's test asks,
    and the hottest token's share within 4 sigma of the reference's batch
    of the same size (the streams differ; the distribution does not)."""
    b, _ = make_batch(DataConfig(zipf_s=1.2), QWEN, 8, 128, init_state(),
                      device=CPU)
    toks = b["tokens"].reshape(-1).numpy()
    assert np.bincount(toks).max() > 32
    rcfg = ref_get_config("qwen2-0.5b", smoke=True)
    rb, _ = ref_make_batch(RefDataConfig(zipf_s=1.2), rcfg, 8, 128,
                           ref_init_state())
    rtoks = np.asarray(rb["tokens"]).reshape(-1)
    p_port, p_ref = (np.mean(t == 0) for t in (toks, rtoks))
    sigma = np.sqrt(p_ref * (1 - p_ref) / toks.size)
    assert abs(p_port - p_ref) < 4 * np.sqrt(2) * sigma, (p_port, p_ref)
    assert toks.min() >= 0 and toks.max() < QWEN.vocab


def test_labels_shift():
    b, _ = make_batch(DataConfig(), QWEN, 2, 16, init_state(), device=CPU)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_embedding_inputs_match_the_reference_shapes(arch):
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    b, _ = make_batch(DataConfig(), cfg, 2, 8, init_state(), device=CPU)
    rb, _ = ref_make_batch(RefDataConfig(), rcfg, 2, 8, ref_init_state())
    assert b.keys() == rb.keys()
    for k in b:
        assert tuple(b[k].shape) == rb[k].shape, k
        assert str(b[k].dtype).removeprefix("torch.") == rb[k].dtype.name, k
    assert int(b["labels"].min()) >= 0 and int(b["labels"].max()) < cfg.vocab


# ------------------------------------------------------------ checkpoint

def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _zeros(t):
    if isinstance(t, dict):
        return {k: _zeros(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_zeros(v) for v in t]
    if isinstance(t, tuple):
        return type(t)(*(_zeros(v) for v in t)) if hasattr(t, "_fields") \
            else tuple(_zeros(v) for v in t)
    return torch.zeros_like(t)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree()
    ck.save(10, t)
    got = ck.restore(None, _zeros(t))
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for s in (5, 10, 15):
        ck.save(s, tree(s))
    ck.wait()
    assert ck.latest_step() == 15
    got = Checkpointer(str(tmp_path)).restore(None, _zeros(tree()))
    assert torch.equal(got["a"], tree(15)["a"])


def test_crash_between_prepare_and_commit_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree(1))
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp-dead"))
    with open(os.path.join(str(tmp_path), "journal.jsonl"), "a") as f:
        f.write(json.dumps({"event": "assign", "step": 99, "order": 77})
                + "\n")
    ck2 = Checkpointer(str(tmp_path), async_save=False)
    assert ck2.latest_step() == 1            # 99 never committed
    restored = ck2.restore(None, _zeros(tree(1)))
    assert torch.equal(restored["a"], tree(1)["a"])


def test_journal_recovery_is_idempotent(tmp_path):
    p = os.path.join(str(tmp_path), "j.jsonl")
    j = Journal(p)
    o1 = j.assign(1)
    j.commit(1, o1)
    o2 = j.assign(2)                          # crash before commit
    del j
    j2 = Journal(p)
    assert j2.latest_committed() == 1
    del j2
    j3 = Journal(p)
    assert j3.latest_committed() == 1
    assert j3.assign(3) > o2                  # monotone hot_update_order


def test_gc_keeps_recent(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    for s in range(1, 7):
        ck.save(s, tree(s))
    ck.gc(keep=2)
    kept = sorted(glob.glob(os.path.join(str(tmp_path), "step_*")))
    assert [os.path.basename(k) for k in kept] == ["step_00000005",
                                                  "step_00000006"]


def test_restore_takes_dtype_from_like_and_checks_shapes(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree(3)
    ck.save(4, t)
    like = _zeros(t)
    like["a"] = like["a"].double()
    got = ck.restore(4, like, device=CPU)
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], t["a"].double())
    like["a"] = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(4, like)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(4, {"a": t["a"]})


@pytest.mark.parametrize("async_save", [False, True])
def test_bf16_leaves_roundtrip_bit_for_bit(tmp_path, async_save):
    """bf16 parameters and 16-bit AdamW moments (the reference cannot
    restore a bf16 leaf: ROADMAP queue 3) come back bit for bit, with the
    8-bit moments' int8 and f32 leaves; the manifest names each dtype."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((4,), generator=g).to(torch.bfloat16),
              "b": torch.randn((2, 3), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    saved = []
    for bits in (16, 8):
        opt = adamw.init(params, bits)
        p, opt, _ = adamw.apply(adamw.AdamWConfig(state_bits=bits), grads,
                                opt, params)
        saved.append((p, opt))
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    ck.save(1, saved)
    ck.wait()
    got = ck.restore(1, _zeros(saved))
    for a, b in zip(_leaves(saved), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert saved[0][1].m["a"].dtype == torch.bfloat16
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        dtypes = json.load(f)["dtypes"]
    assert "bfloat16" in dtypes and "int8" in dtypes


def _exchange_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(16, 8)).astype(np.float32),
            "b": {"c": np.arange(10, dtype=np.int32),
                  "d": np.float32(3.5),
                  "e": rng.integers(-127, 128, (3, 4)).astype(np.int8)}}


def test_checkpoints_exchange_with_the_reference(tmp_path):
    """f32, i32 and i8 leaves: the reference's files restore in the port
    and the port's in the reference, equal."""
    t = _exchange_tree(0)
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        3, jax.tree.map(jnp.asarray, t))
    got = Checkpointer(str(tmp_path / "ref"), async_save=False).restore(
        None, _zeros({"a": torch.zeros(16, 8),
                      "b": {"c": torch.zeros(10, dtype=torch.int32),
                            "d": torch.zeros(()),
                            "e": torch.zeros((3, 4), dtype=torch.int8)}}))
    for a, b in zip(_leaves(t), _leaves(got)):
        np.testing.assert_array_equal(b.numpy(), a)
        assert b.numpy().dtype == np.asarray(a).dtype
    t2 = _exchange_tree(1)
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        5, {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
                else {kk: torch.from_numpy(np.asarray(vv))
                      for kk, vv in v.items()}) for k, v in t2.items()})
    ref = RefCheckpointer(str(tmp_path / "port"), async_save=False)
    assert ref.latest_step() == 5
    back = ref.restore(None, jax.tree.map(jnp.zeros_like,
                                          jax.tree.map(jnp.asarray, t2)))
    for a, b in zip(jax.tree.leaves(t2), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a)
        assert np.asarray(b).dtype == np.asarray(a).dtype


# ------------------------------------------------------ fault, straggler

def test_fault_planning_equals_the_reference(tmp_path):
    hb, rhb = HeartbeatMonitor(timeout_s=10), RefHeartbeat(timeout_s=10)
    for m in (hb, rhb):
        m.beat(0, now=0.0)
        m.beat(1, now=0.0)
        m.beat(0, now=20.0)
    assert hb.failed(now=21.0) == rhb.failed(now=21.0) == [1]
    assert hb.alive(now=21.0) == rhb.alive(now=21.0) == [0]
    for old, new, n in (([0, 1, 2, 3], [0, 2, 3], 16), ([0, 1], [1], 5),
                        ([0, 1, 2], [0, 1, 2], 2)):
        plan = reshard_plan(old, new, n)
        assert plan == ref_reshard_plan(old, new, n)
        assert sorted(s for v in plan.values() for s in v) == list(range(n))
    for n_dev, m in ((240, 16), (100, 16), (7, 4), (1, 16)):
        assert elastic_mesh_shape(n_dev, m) == ref_elastic(n_dev, m)
    j, rj = (Journal(str(tmp_path / "j.jsonl")),
             RefJournal(str(tmp_path / "rj.jsonl")))
    for jj in (j, rj):
        jj.commit(7, jj.assign(7))
    hb, rhb = HeartbeatMonitor(timeout_s=5), RefHeartbeat(timeout_s=5)
    for m in (hb, rhb):
        for h in range(4):
            m.beat(h, now=0.0)
        m.beat(3, now=100.0)
    dec = plan_recovery(hb, j, devices_per_host=8, model_axis=4, now=101.0)
    rdec = ref_plan_recovery(rhb, rj, devices_per_host=8, model_axis=4,
                             now=101.0)
    assert dataclasses.asdict(dec) == dataclasses.asdict(rdec)
    assert dec.restore_step == 7 and dec.mesh_shape[1] == 4


def test_straggler_planning_equals_the_reference():
    det = StragglerDetector(alpha=1.0, threshold=1.4, eject_after=2)
    rdet = RefStraggler(alpha=1.0, threshold=1.4, eject_after=2)
    for _ in range(3):
        for h in range(4):
            det.observe(h, 1.0 if h else 2.0)       # host 0 slow
            rdet.observe(h, 1.0 if h else 2.0)
        assert det.stragglers() == rdet.stragglers()
    assert det.stragglers() == [0] and det.ejections() == [0] == \
        rdet.ejections()
    d2, r2 = StragglerDetector(), RefStraggler()
    for t in (1.0, 1.3, 0.7, 3.1, 0.9):
        for h in range(3):
            d2.observe(h, t * (1 + h))
            r2.observe(h, t * (1 + h))
        assert d2.stragglers() == r2.stragglers()
    assert d2.median() == r2.median()
    plan = {0: [0, 1, 2, 3], 1: [4, 5], 2: [6, 7]}
    for frac in (0.5, 0.25, 1.0):
        new = rebalance(plan, straggler=0, fraction=frac)
        assert new == ref_rebalance(plan, straggler=0, fraction=frac)
        assert sorted(s for v in new.values() for s in v) == list(range(8))


# -------------------------------------------------------------- sharding

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _abstract_mesh(shape, names):
    try:                        # jax >= 0.4.38: (axis_sizes, axis_names)
        return AbstractMesh(shape, names)
    except TypeError:           # jax 0.4.37: ((name, size), ...) pairs
        return AbstractMesh(tuple(zip(names, shape)))


def _norm(spec):
    """A spec with one-axis tuples written as the axis (PartitionSpec reads
    ("data",) and "data" alike, and may print either)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec_pairs(port, ref, path=""):
    """(path, port spec, reference spec without its layers axis) for every
    parameter: the port's per-repeat lists against the reference's stacked
    leaves."""
    if isinstance(port, dict):
        assert port.keys() == ref.keys(), path
        for k in port:
            yield from _spec_pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        for r, layer in enumerate(port):
            yield from _unstacked(layer, ref, f"{path}[{r}]")
    else:
        yield path, port, tuple(ref)


def _unstacked(port, ref, path):
    if isinstance(port, dict):
        for k in port:
            yield from _unstacked(port[k], ref[k], f"{path}/{k}")
    else:
        assert ref[0] is None, (path, ref)    # "layers": replicated
        yield path, port, tuple(ref)[1:]


def test_resolver_cases():
    """tests/test_sharding.py's resolver cases on the port."""
    mesh = {"data": 16, "model": 16}
    assert resolve_spec((7168, 19200), ("embed", "mlp"), mesh,
                        RULES["train"]) == ("data", "model")
    assert resolve_spec((32256, 7168), ("vocab", "embed"), mesh,
                        RULES["train"])[0] == ("data", "model")
    rep = ResolveReport()
    assert resolve_spec((151936, 896), ("vocab", "embed"), mesh,
                        RULES["train"], rep)[0] == "model"
    s = resolve_spec((128, 7168, 4864), ("experts", "embed", "mlp"), mesh,
                     RULES["train"])
    used = [a for e in s if e for a in (e if isinstance(e, tuple) else (e,))]
    assert len(set(used)) == len(used)
    assert resolve_spec((7,), ("heads",), mesh, RULES["train"]) == (None,)
    assert resolve_spec((896, 4864), ("embed", "mlp"), mesh,
                        RULES["serve"]) == (None, "model")
    s = resolve_spec((128, 7168, 4864), ("experts", "embed", "mlp"), mesh,
                     RULES["serve"])
    assert s[0] == "model" and s[2] == "data"
    assert RULES == REF_RULES


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_equal_the_reference_for_every_arch(mesh_name):
    """Every architecture at full width, every rule set: the port's spec of
    each layer's parameter equals the reference's stacked spec without its
    layers axis, and the fallbacks reported name the same axes."""
    shape, names = MESHES[mesh_name]
    amesh = _abstract_mesh(shape, names)
    mesh = dict(zip(names, shape))
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for mode in RULES:
            rep, rrep = ResolveReport(), RefReport()
            port = param_pspecs(lm_spec(cfg), mesh, mode, rep)
            ref = ref_param_pspecs(ref_lm_spec(rcfg), amesh, mode)
            n = 0
            for path, got, want in _spec_pairs(port, ref):
                assert got == want, (arch, mode, path, got, want)
                n += 1
            assert n == len(jax.tree.leaves(
                lm_spec(cfg), is_leaf=lambda x: hasattr(x, "axes")))
            # the reference's report, from its resolver on the same specs
            jax.tree.map(lambda s: ref_resolve_spec(
                s.shape, s.axes, amesh, REF_RULES[mode], rrep),
                ref_lm_spec(rcfg), is_leaf=lambda x: hasattr(x, "axes"))
            assert {f[2:] for f in rep.fallbacks} == \
                {f[2:] for f in rrep.fallbacks}, (arch, mode)


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b", "qwen2-0.5b",
                                  "recurrentgemma-2b"])
def test_cache_and_batch_specs_equal_the_reference(arch):
    """decode_32k-sized caches (on the meta device: shapes only) against the
    reference's stacked cache specs, and the batch specs."""
    for mesh_name, (shape, names) in MESHES.items():
        amesh = _abstract_mesh(shape, names)
        mesh = dict(zip(names, shape))
        caches = lm_init_cache(get_config(arch), 128, 32768, device="meta")
        specs = cache_pspecs(caches, mesh)
        ref = lm_cache_shapes(ref_get_config(arch), 128, 32768)
        for g, gt in specs.items():
            for u, layers in gt.items():
                rc = ref[g][u]
                for layer in layers:
                    for name, got, leaf in zip(rc._fields, layer, rc):
                        want = _norm(ref_cache_spec(amesh, name, leaf.shape,
                                                    True))
                        assert _norm(got) == want[1:], (arch, g, u, name,
                                                       got, want)
                        assert got == cache_leaf_pspec(mesh, name,
                                                       leaf.shape[1:])
        for nd, bd in ((2, 0), (3, 1), (4, 0)):
            assert _norm(batch_pspec(mesh, nd, bd)) == _norm(
                ref_batch_pspec(amesh, nd, bd))


# ----------------------------------------------------------------- train

def test_train_restart_equals_the_uninterrupted_run(tmp_path, capsys):
    """Four steps straight, against two steps (their last checkpoint at
    step 2) and a fresh train() that resumes there: the resumed steps'
    losses equal the uninterrupted run's bit for bit. (Steps 1-4 lie in
    AdamW's warmup, where decay_steps, set from ``steps``, plays no
    part.)"""
    kw = dict(arch="qwen2-0.5b", smoke=True, batch=2, seq=16, ckpt_every=2,
              device=CPU)
    full = train(steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    first = train(steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    records = []
    rest = train(steps=4, ckpt_dir=str(tmp_path / "b"),
                 on_step=records.append, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(full) == 4 and first == full[:2] and rest == full[2:]
    assert [r["step"] for r in records] == [2, 3]
    assert all(np.isfinite(r["grad_norm"]) and r["seconds"] > 0
               for r in records)
    assert Checkpointer(str(tmp_path / "b")).latest_step() == 4
    assert train(steps=4, ckpt_dir=str(tmp_path / "b"), **kw) == []


def test_train_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="no backward"):
        train("qwen2-0.5b", True, 1, 2, 16, None, use_kernel=True,
              device=CPU)
    with pytest.raises(ValueError, match="model_axis"):
        train("qwen2-0.5b", True, 1, 2, 16, None, model_axis=2, device=CPU)
