"""Rules of the port: ``repro_torch`` and ``chip_smoke.py`` stand alone (no
JAX, no reference package), and entry points default to the CUDA card."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "multicard_smoke.py"]


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


def test_default_device_needs_cuda(no_cuda, tmp_path):
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
    # the model slice: init, prefill, the server and the flash wrapper
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import GroupServer
    from repro_torch.models import init_params, lm_spec, prefill
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(lm_spec(cfg), 0)
    params = init_params(lm_spec(cfg), 0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill(params, cfg, tokens=tokens)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroupServer(cfg, params)
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, q, q)
    logits, _ = prefill(params, cfg, tokens=tokens, device="cpu")
    assert logits.shape == (1, 1, cfg.padded_vocab)
    # every other family's serving path: MLA + MoE, and the recurrent caches
    from repro_torch.models import lm_init_cache
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = init_params(lm_spec(cfg), 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill(params, cfg, tokens=tokens)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_init_cache(get_config("mamba2-1.3b", smoke=True), 1, 4)
    logits, _ = prefill(params, cfg, tokens=tokens, device="cpu")
    assert logits.shape == (1, 1, cfg.padded_vocab)
    # the governor and the serving layer
    from repro_torch.adaptive import FixedPolicy, GovernorCell, run_governed
    from repro_torch.core.lock import stationary
    from repro_torch.serving import ServeCell, saturating, serve
    wl = WorkloadSpec(n_rows=64)
    gcell = GovernorCell("g", FixedPolicy("group"), stationary(wl, 2), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_governed([gcell], horizon=200, n_segments=2)
    scell = ServeCell(name="s", schedule=saturating(8, 200), workload=wl,
                      n_threads=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve([scell], seg_ticks=100)
    assert run_governed([gcell], horizon=200, n_segments=2,
                        device="cpu").segments["g"][-1]["t1"] == 200
    assert serve([scell], seg_ticks=100,
                 device="cpu").serving["s"].arrived == 8
    # the tracer, the profiler and the certifier
    from repro_torch.analysis import certify_run
    from repro_torch.obs import make_trace, profile_step, simulate_traced
    from repro_torch.core.lock import (CostModel, EngineConfig,
                                       protocol_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trace(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_traced("mysql", wl, n_threads=4, horizon=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        certify_run("mysql", wl, 4, horizon=100)
    cfg = EngineConfig(protocol=protocol_params("mysql"), costs=CostModel(),
                       workload=wl, n_threads=4, horizon=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step(cfg, n_iters=2, repeats=1)
    assert certify_run("mysql", wl, 4, horizon=100, device="cpu").ok
    # the training half: data, the train step, the driver, restoring onto a
    # named device; grouped_embed runs where its table lies
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw, grouped_embed
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(DataConfig(), cfg, 2, 8, init_state())
    batch, _ = make_batch(DataConfig(), cfg, 2, 8, init_state(),
                          device="cpu")
    assert batch["tokens"].device.type == "cpu"
    params = init_params(lm_spec(cfg), 0, device="cpu")
    opt = adamw.init(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, adamw.AdamWConfig())(params, opt, batch)
    new, _, m = make_train_step(cfg, adamw.AdamWConfig(), device="cpu")(
        params, opt, batch)
    assert new["ln_f"]["scale"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen2-0.5b", True, 1, 2, 8, None)
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(1, {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(1, {"w": torch.zeros(3)}, device="cuda")
    assert ckpt.restore(1, {"w": torch.zeros(3)})["w"].device.type == "cpu"
    table = torch.randn((8, 2), requires_grad=True)
    out = grouped_embed(table, torch.tensor([1, 1, 3]))
    (g,) = torch.autograd.grad(out.sum(), table)
    assert g.device.type == "cpu" and float(g[1, 0]) == 2.0


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """CPU tensors take the plain version; anything else that is not a
    CUDA tensor pair (segment_sums) or triple (flash_attention) of the right
    types raises before any launch."""
    from repro_torch.kernels.grouped_scatter import segment_sums
    seg = torch.zeros((4,), dtype=torch.int32)
    out = segment_sums(seg, torch.ones((4, 3)), 2)
    assert out.shape == (2, 3) and float(out[0, 0]) == 4.0
    before = segment_sums.launches
    with pytest.raises(ValueError):
        segment_sums(seg, torch.ones((4, 3), device="meta"), 2)
    assert segment_sums.launches == before
    # the flash wrapper: without a card a non-CPU tensor already fails for
    # the missing card, with one for its device, type or shape
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     attention_ref)
    q = torch.randn((1, 5, 4, 16))
    kv = torch.randn((1, 7, 2, 16))
    torch.testing.assert_close(flash_attention(q, kv, kv),
                               attention_ref(q, kv, kv))
    before = flash_attention.launches
    meta = torch.zeros((1, 7, 2, 16), device="meta")
    qm = torch.zeros((1, 5, 4, 16), device="meta")
    for args in [(q, meta, meta), (qm, meta, meta),
                 (qm.half(), meta.half(), meta.half())]:
        with pytest.raises((RuntimeError, ValueError, TypeError)):
            flash_attention(*args)
    assert flash_attention.launches == before
    # the head dims the kernels have (240: gemma3-12b's global layers, bf16
    # on the wgmma kernel, f32 on the 3xTF32 one) pass the shape check;
    # others raise before a launch
    from repro_torch.kernels.flash_attention.ops import check_shapes, route
    for D in (16, 32, 64, 128, 240):
        qd = torch.zeros((1, 5, 4, D), device="meta", dtype=torch.bfloat16)
        kd = torch.zeros((1, 7, 2, D), device="meta", dtype=torch.bfloat16)
        check_shapes(qd, kd, kd)
        assert route(qd, kd, kd) == "wgmma"  # bf16: every head dim
        qf, kf = qd.float(), kd.float()      # f32: the 3xTF32 wgmma kernel
        assert route(qf, kf, kf) == "tf32x3"
    for D in (8, 48, 96, 256):
        qd = torch.zeros((1, 5, 4, D), device="meta")
        kd = torch.zeros((1, 7, 2, D), device="meta")
        with pytest.raises(ValueError, match="unsupported sizes"):
            check_shapes(qd, kd, kd)
    q240, kv240 = torch.randn((1, 5, 4, 240)), torch.randn((1, 7, 2, 240))
    torch.testing.assert_close(flash_attention(q240, kv240, kv240),
                               attention_ref(q240, kv240, kv240))
    assert flash_attention.launches == before


def test_kernel_wrappers_refuse_gradients():
    """The kernels compute forward passes only: an input that requires grad
    under grad mode raises before the route is chosen, so the CPU (whose
    plain version could differentiate) refuses what the card would. Under
    no_grad, or on inputs that need no grad, the wrappers run."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     attention_ref)
    from repro_torch.kernels.grouped_scatter import segment_sums
    q = torch.randn((1, 5, 4, 16), requires_grad=True)
    kv = torch.randn((1, 7, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.detach(), kv.requires_grad_(True), kv)
    meta = torch.zeros((1, 5, 4, 16), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(meta, meta, meta)
    with torch.no_grad():
        torch.testing.assert_close(flash_attention(q, kv, kv),
                                   attention_ref(q, kv, kv))
    seg = torch.zeros((4,), dtype=torch.int32)
    upd = torch.ones((4, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        segment_sums(seg, upd, 2)
    with torch.no_grad():
        assert float(segment_sums(seg, upd, 2)[0, 0]) == 4.0
    assert float(segment_sums(seg, upd.detach(), 2)[0, 0]) == 4.0


def test_kernel_build_names_by_hash_and_needs_nvcc(tmp_path, monkeypatch):
    """The shared nvcc helper: one library per source content, built once,
    renamed into place; a clear error where there is no nvcc."""
    from repro_torch.kernels import nvcc_build
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc_build.build_library(src)
    monkeypatch.undo()
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != -o ]; do '
                    'shift; done\ntouch "$2"\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc_build, "nvcc", lambda: str(fake))
    first = nvcc_build.build_library(src)
    assert first.parent == tmp_path / "build" and first.exists()
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert nvcc_build.build_library(src) == first      # reused, not rebuilt
    src.write_text("// two\n")
    assert nvcc_build.build_library(src) != first      # new bytes, new name
    assert calls.read_text().count("x") == 2
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_verbose_build_always_compiles_and_keeps_the_report(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """A verbose build (chip_smoke.py's) compiles when the library exists
    without its report, so ptxas's report of registers and spills is always
    there, beside the library; once both exist it reuses them."""
    from repro_torch.kernels import nvcc_build
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text('#!/bin/sh\necho x >> "%s"\n'
                    'echo "ptxas info    : Used 7 registers" >&2\n'
                    'while [ "$1" != -o ]; do shift; done\ntouch "$2"\n'
                    % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc_build, "nvcc", lambda: str(fake))
    lib = nvcc_build.build_library(src)
    assert not nvcc_build.report_path(lib).exists()
    assert nvcc_build.build_library(src, verbose=True) == lib
    assert "Used 7 registers" in nvcc_build.report_path(lib).read_text()
    assert calls.read_text().count("x") == 2
    assert nvcc_build.build_library(src, verbose=True) == lib   # reused
    assert "Used 7 registers" in capsys.readouterr().out
    assert calls.read_text().count("x") == 2
