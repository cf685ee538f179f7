"""Train-step parity for the MoE smoke architectures (arctic's dense+MoE,
deepseek-v2-lite's MLA + MoE); bars in ``torch_train_parity.py``."""
import pytest
import torch

from torch_train_parity import check_train_step

ARCHS_HERE = ("arctic-480b", "deepseek-v2-lite-16b")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
