"""Rules of the port: ``repro_torch`` and ``chip_smoke.py`` stand alone (no
JAX, no reference package), and entry points default to the CUDA card."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    assert (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_needs_cuda(no_cuda):
    from repro_torch import device
    from repro_torch.core import group_apply, init_hotspot
    from repro_torch.core.lock import simulate, WorkloadSpec
    from repro_torch.kernels.grouped_scatter import grouped_scatter_apply
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate("group", WorkloadSpec(n_rows=64), n_threads=4, horizon=100)
    table, ids = torch.zeros((8, 2)), torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grouped_scatter_apply(table, ids, torch.ones((3, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        group_apply(table, ids, torch.ones((3, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_hotspot(8)
    assert device.resolve("cpu") == torch.device("cpu")


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """CPU tensors take the plain version; anything else that is not a
    CUDA tensor pair of the right types raises before any launch."""
    from repro_torch.kernels.grouped_scatter import segment_sums
    seg = torch.zeros((4,), dtype=torch.int32)
    out = segment_sums(seg, torch.ones((4, 3)), 2)
    assert out.shape == (2, 3) and float(out[0, 0]) == 4.0
    before = segment_sums.launches
    with pytest.raises(ValueError):
        segment_sums(seg, torch.ones((4, 3), device="meta"), 2)
    assert segment_sums.launches == before
