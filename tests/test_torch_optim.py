"""The optimizer path of the port against the JAX reference: AdamW's
update at 32-, 16- and 8-bit moment widths (params, m and v to 1e-6
relative, int8 moments equal), its schedule, convergence at every width;
the hotspot-grouped embedding (forward and gradient); int8 quantization and
the quantized ring all-reduce, equal bit for bit to the reference's, on one
rank and on four (gloo processes against the reference's ``shard_map`` over
four forced host devices)."""
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import quantize as ref_quantize
from repro.optim.hotspot_update import _bwd as ref_grouped_embed_bwd
from repro_torch.optim import (adamw, dequantize, grouped_embed, quantize,
                               quantized_psum, serial_embed)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPES = {"a": (16, 8), "b": {"c": (32,), "d": (4, 4, 8)}}


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=SHAPES["a"])).astype(np.float32),
            "b": {k: (scale * rng.normal(size=s)).astype(np.float32)
                  for k, s in SHAPES["b"].items()}}


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy() \
            if t.dtype == torch.bfloat16 else t.detach().numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16
                      else t)


def _torch(t):
    if isinstance(t, dict):
        return {k: _torch(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t))


def _close(got, want, rtol=1e-6):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], rtol)
        return
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_adamw_apply_matches_reference(bits):
    """Three steps from the same parameters and moments on the same
    gradients; the first clipped (global norm above clip_norm), the others
    not."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, state_bits=bits)
    cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(bits)
    p0 = _tree(rng)
    rp, rs = jax.tree.map(jnp.asarray, p0), ref_adamw.init(
        jax.tree.map(jnp.asarray, p0), bits)
    p, s = _torch(p0), adamw.init(_torch(p0), bits)
    for i, gscale in enumerate((1.0, 0.01, 0.02)):
        g = _tree(rng, gscale)
        rp, rs, rm = ref_adamw.apply(rcfg, jax.tree.map(jnp.asarray, g), rs,
                                     rp)
        p, s, m = adamw.apply(cfg, _torch(g), s, p)
        assert (float(rm["grad_norm"]) > 1.0) == (i == 0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert float(m["lr"]) == float(rm["lr"])
        assert int(s.step) == int(rs.step) == i + 1
        _close(_np(p), _np(rp))
        for got, want in ((s.m, rs.m), (s.v, rs.v)):
            _close(_np(got), _np(want))
        if bits == 16:
            assert s.m["a"].dtype == torch.bfloat16
        if bits == 8:
            assert s.m["a"]["q"].dtype == torch.int8
            assert s.m["a"]["s"].shape == (16, 1)


def test_schedule_matches_reference():
    for kw in (dict(), dict(warmup_steps=5, decay_steps=40, min_lr=1e-4),
               dict(warmup_steps=0, decay_steps=1)):
        cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
        steps = np.arange(0, 12_000, 37, dtype=np.int32)
        want = np.asarray(ref_adamw.schedule(rcfg, jnp.asarray(steps)))
        got = adamw.schedule(cfg, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_adamw_converges_all_state_widths(bits):
    """The port's version of tests/test_runtime.py's."""
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=1, decay_steps=1000,
                            weight_decay=0.0, state_bits=bits)
    params = {"w": torch.ones((64,)) * 3.0}
    opt = adamw.init(params, bits)
    for _ in range(60):
        params, opt, _ = adamw.apply(cfg, {"w": 2 * params["w"]}, opt,
                                     params)
    assert float(params["w"].abs().max()) < 0.5


def test_grouped_embed_forward_and_gradient():
    """Forward equals table[tokens]; the gradient equals serial_embed's and
    the reference's VJP rule in f32, on Zipf tokens (hot rows repeat). The
    rule is called directly: ``jax.vjp`` through the reference's
    ``grouped_embed`` raises under this JAX (its forward keeps the table's
    dtype among the residuals; ROADMAP queue 3)."""
    rng = np.random.default_rng(0)
    V, d = 64, 8
    table = rng.normal(size=(V, d)).astype(np.float32)
    tokens = np.minimum(rng.zipf(1.3, size=(4, 50)) - 1, V - 1).astype(
        np.int32)
    ct = rng.normal(size=(4, 50, d)).astype(np.float32)
    assert np.bincount(tokens.reshape(-1)).max() > 32      # a hot row
    t = torch.from_numpy(table).requires_grad_(True)
    out = grouped_embed(t, torch.from_numpy(tokens))
    assert torch.equal(out, torch.from_numpy(table[tokens]))
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(ct))
    t2 = torch.from_numpy(table).requires_grad_(True)
    (g_serial,) = torch.autograd.grad(
        serial_embed(t2, torch.from_numpy(tokens)), t2, torch.from_numpy(ct))
    g_ref, _ = ref_grouped_embed_bwd(
        (jnp.asarray(tokens), table.shape, jnp.float32), jnp.asarray(ct))
    torch.testing.assert_close(g, g_serial, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)
    assert g.dtype == torch.float32 and g.device.type == "cpu"


def test_quantize_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 2048)) * [[1.0], [1e-3], [50.0]]).astype(
        np.float32)
    q, s = quantize(torch.from_numpy(x))
    rq, rs = ref_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert np.abs(dequantize(q, s).numpy() - x).max() <= \
        float(np.abs(x).max()) / 127


def _inputs(world: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(world, n)).astype(np.float32),
            "residual": (0.01 * rng.normal(size=(world, n))).astype(
                np.float32)}


REF_RING = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.optim import quantized_psum
d = np.load(sys.argv[1])
mesh = jax.make_mesh(({world},), ("d",))
f = shard_map(lambda v, r: tuple(o[None] for o in
                                 quantized_psum(v[0], "d", r[0])),
              mesh, in_specs=(P("d"), P("d")), out_specs=(P("d"), P("d")),
              check_rep=False)
out, err = f(jnp.asarray(d["x"]), jnp.asarray(d["residual"]))
np.savez(sys.argv[2], out=np.asarray(out), err=np.asarray(err))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_quantized_psum_single_rank_matches_reference():
    """No process group: a ring of one (the reference on a one-device
    mesh), residual fed back."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.optim import quantized_psum as ref_psum
    d = _inputs(1, 5000, 2)
    mesh = jax.make_mesh((1,), ("d",))
    f = shard_map(lambda v, r: ref_psum(v, "d", r), mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()), check_rep=False)
    want, werr = f(jnp.asarray(d["x"][0]), jnp.asarray(d["residual"][0]))
    got, err = quantized_psum(torch.from_numpy(d["x"][0]),
                              residual=torch.from_numpy(d["residual"][0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(err.numpy(), np.asarray(werr))


def test_quantized_psum_four_ranks_match_reference(tmp_path):
    """Four gloo processes against the reference's ring over four forced
    host devices: every rank's sum and residual equal bit for bit (N = 5,000
    pads the last block)."""
    from torch_ring_worker import ring_rank
    world = 4
    path = str(tmp_path / "in.npz")
    np.savez(path, **_inputs(world, 5000, 3))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_RING.format(world=world), path,
         str(tmp_path / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = _free_port()
    with ProcessPoolExecutor(world, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futs = [pool.submit(ring_rank, r, world, port, path)
                for r in range(world)]
        got = [f.result(timeout=120) for f in futs]
    _, stderr = ref.communicate(timeout=300)
    assert ref.returncode == 0, stderr[-2000:]
    with np.load(tmp_path / "ref.npz") as want:
        for r, (out, err) in enumerate(got):
            np.testing.assert_array_equal(out, want["out"][r])
            np.testing.assert_array_equal(err, want["err"][r])
    x = np.load(path)["x"]
    assert np.abs(got[0][0] - x.sum(0)).max() < 0.05 * np.abs(x).max() * 4
