"""Train-step parity for the dense-attention smoke architectures and
musicgen's codebook heads (the bars are in ``torch_train_parity.py``; the
others are in ``test_torch_train_step_moe.py`` and
``test_torch_train_step_mixers.py``), and the port's own train-step checks
for all ten.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, lm_spec
from repro_torch.optim import adamw
from torch_train_parity import OPT, batch_np, check_train_step

CPU = "cpu"
ARCHS_HERE = ("qwen2-0.5b", "deepseek-coder-33b", "command-r-35b",
              "gemma3-12b", "musicgen-medium")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    """The port's version of tests/test_models_smoke.py's: eight steps on
    one fixed batch at the smoke config (its own activation dtype)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(lm_spec(cfg), 1, device=CPU)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT), device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, 1).items()}
    if "embeds" in batch:
        batch["embeds"] = batch["embeds"].to(torch.bfloat16)
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), arch
    assert losses[-1] < losses[0], (arch, losses)


def test_train_step_refuses_the_kernel_path():
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, adamw.AdamWConfig(), use_kernel=True,
                        device=CPU)
