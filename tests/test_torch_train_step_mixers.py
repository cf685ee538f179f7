"""Train-step parity for the recurrent mixers (RG-LRU, SSD) and qwen2-vl's
M-RoPE over embedding inputs; bars in ``torch_train_parity.py``."""
import pytest
import torch

from torch_train_parity import check_train_step

ARCHS_HERE = ("recurrentgemma-2b", "mamba2-1.3b", "qwen2-vl-2b")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
