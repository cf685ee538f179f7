"""Train-step parity (a helper, not a test file; the test files
``test_torch_train_step*.py`` split the ten smoke architectures among
them): one ``make_train_step`` per architecture in f32
(``act_dtype="float32"``), the port against the JAX reference on the same
weights, optimizer state and numpy batch.

Bars: the loss within 1e-5 relative; the grad norm, and every gradient leaf
elementwise, within 2e-4 of the leaf's max |g|. Parameters after the step
carry AdamW's step-1 sign hazard: at step 1 the update is
``lr * (g / (|g| + eps) + wd * p)``, so where |g| is as small as the
gradient bar a difference of one bar flips a whole ``lr``. So where the
reference's |g| exceeds twice the leaf's gradient bar the new parameter must
agree within ``lr * eps / (2 bar)`` (twice the most that one bar of
gradient difference can move g / (|g| + eps) there; clipping scales bar and
g alike) plus 1e-6 relative; every element within ``2 lr`` plus 1e-6
relative (a full flip), and elements that moved by more than 1e-3 lr must be
rare (at most 1 %).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import (lm_spec as ref_lm_spec,
                          init_params as ref_init_params,
                          loss_fn as ref_loss_fn)
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.optim import adamw

B, S = 2, 16
CPU = "cpu"
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=100)


def _ref_step(cfg, opt_cfg):
    """The reference's train step, split so its gradients can be read too:
    value_and_grad of its loss_fn, then its adamw.apply (what its
    make_train_step composes)."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, cfg, b), has_aux=True))
    upd = jax.jit(lambda g, o, p: ref_adamw.apply(opt_cfg, g, o, p))
    return vg, upd


def batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embed_inputs:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    else:
        b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    lshape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    b["labels"] = rng.integers(0, cfg.vocab, lshape, dtype=np.int32)
    b["labels"][0, :3] = -1                      # masked positions
    if cfg.mrope:
        b["positions3"] = np.sort(rng.integers(0, 3 * S, (3, B, S)),
                                  axis=-1).astype(np.int32)
    return b


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def check_train_step(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               act_dtype="float32")
    opt_cfg, ropt_cfg = (adamw.AdamWConfig(**OPT),
                         ref_adamw.AdamWConfig(**OPT))
    rparams = ref_init_params(ref_lm_spec(rcfg), jax.random.PRNGKey(3))
    ropt = ref_adamw.init(rparams)
    batch = batch_np(cfg, 5)
    vg, upd = _ref_step(rcfg, ropt_cfg)
    (rloss, rmet), rgrads = vg(rparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    rnew, rnopt, rom = upd(rgrads, ropt, rparams)

    host = jax.device_get
    params = params_from_numpy(host(rparams), device=CPU)
    opt = opt_state_from_numpy(host(ropt), device=CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met, grads = value_and_grad(params, cfg, tb, device=CPU)
    step = make_train_step(cfg, opt_cfg, device=CPU)
    new, nopt, om = step(params, opt, tb)

    assert float(om["loss"]) == float(loss)          # the step's own loss
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(rmet["aux"]),
                               rtol=1e-5, atol=1e-6)
    lr = float(rom["lr"])
    assert float(om["lr"]) == lr == np.float32(OPT["peak_lr"])
    assert int(nopt.step) == int(rnopt.step) == 1

    g_port = dict(_leaves(params_to_numpy(grads)))
    g_ref = dict(_leaves(host(rgrads)))
    p_old = dict(_leaves(host(rparams)))
    p_new = dict(_leaves(params_to_numpy(new)))
    p_ref = dict(_leaves(host(rnew)))
    assert g_port.keys() == g_ref.keys() == p_new.keys()
    gmax = max(float(np.abs(g).max()) for g in g_ref.values())
    np.testing.assert_allclose(float(om["grad_norm"]),
                               float(rom["grad_norm"]), rtol=2e-4)
    scale = min(1.0, 1.0 / (float(rom["grad_norm"]) + 1e-9))   # clip
    flips, total = 0, 0
    for name, gr in g_ref.items():
        gbar = 2e-4 * float(np.abs(gr).max()) + 1e-12
        err = float(np.abs(g_port[name] - gr).max())
        assert err <= gbar, (arch, name, "grad", err, gbar)
        firm = np.abs(gr) > 2 * gbar
        tol = 1e-6 * np.abs(p_old[name]) + 1e-7
        diff = np.abs(p_new[name] - p_ref[name])
        # a clipped gradient g' = g * scale off by one bar moves
        # g'/(|g'|+eps) by at most eps/(4 bar scale) where |g'| > 2 bars;
        # the bar allows twice that
        firm_tol = tol + lr * 1e-8 / (2 * gbar * scale)
        assert (diff[firm] <= firm_tol[firm]).all(), \
            (arch, name, "param", float(diff[firm].max()))
        assert (diff <= 2 * lr * 1.001 + tol).all(), \
            (arch, name, "param, past a sign flip", float(diff.max()))
        flips += int((diff[~firm] > lr * 1e-3 + tol[~firm]).sum())
        total += diff.size
    assert flips <= 0.01 * total, (arch, flips, total)
    assert gmax > 0
