#!/usr/bin/env python3
"""Build the wgmma flash kernel's head-dim-240 instance in other designs and
compare each with the shipped one on the card, in one process.

    PYTHONPATH=src python tools/flash_sm90_variants.py [--reps 10]

Each variant is a copy of ``csrc/flash_attention_sm90.cu`` whose
``Shape<240>`` line is rewritten, built with nvcc under
``build/kernels/variants/`` and loaded in place of the package's library:

  shipped      no producer warp, the consumers reload the ring, up to 255
               registers a thread, one m64n240k16 P V wgmma a k-step
  producer_wg  a producer warpgroup (setmaxnreg 24 / 240, 384 threads), the
               same P V

For each: ptxas's registers and spill bytes of the instance, the bf16 bar
(``ref.bf16_errors`` with the split's bound) against the plain version at
a ragged shape, and the kernel's time at gemma3-12b's global-layer prefill
(B=1, S=8,192, H=16, K=8, D=240, bf16, causal), the variants timed in turns
(forward, then backward order). Prints one JSON line per variant and the
card's name, power limit and clocks. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import nvcc_build
from repro_torch.kernels.flash_attention import (attention_bf16p_model,
                                                 attention_ref, kernel_sm90)
from repro_torch.kernels.flash_attention.ref import bf16_errors

SHAPE_240 = re.compile(r"template <> struct Shape<240> \{[^}]*\};")
VARIANTS = {
    "shipped": None,
    "producer_wg": "NC = 2,\n  PRODUCER_WARPS = 4, CONSUMER_REGS = 240, "
                   "BK = 64, STAGES = 2, PV_N = 240;",
}


def variant_source(name: str) -> Path:
    """The variant's source file (the package's own for ``shipped``)."""
    if VARIANTS[name] is None:
        return kernel_sm90.SOURCE
    src = kernel_sm90.SOURCE.read_text()
    new, n = SHAPE_240.subn("template <> struct Shape<240> { static "
                            f"constexpr int {VARIANTS[name]} }};", src)
    assert n == 1, "Shape<240> not found in the source"
    path = nvcc_build.BUILD_DIR / "variants" / name / kernel_sm90.SOURCE.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(new)
    return path


def _load(path: Path):
    """A variant's library with the launch entry's argument types."""
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_sm90_launch.argtypes = [
        P, P, P, P, I, I, I, I, I, I, P, ctypes.c_float, I, P]
    lib.flash_attention_sm90_launch.restype = ctypes.c_int
    return lib


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_sm90_variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs, rows = {}, {}
    for name in VARIANTS:
        path = nvcc_build.build_library(variant_source(name), verbose=True)
        usage = [u for u in nvcc_build.ptxas_usage(
            nvcc_build.report_path(path).read_text())
            if kernel_sm90.instance_name(240) in u["kernel"]]
        libs[name] = _load(path)
        rows[name] = {"variant": name, "ptxas": usage[0], "ms_runs": []}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    B, Sq, H, K, D = 1, 200, 16, 8, 240
    q, k, v = rnd((B, Sq, H, D)), rnd((B, Sq, K, D)), rnd((B, Sq, K, D))
    want, model = attention_ref(q, k, v), attention_bf16p_model(q, k, v)
    for name, lib in libs.items():
        kernel_sm90._lib = lib
        out = torch.empty(q.shape, device="cuda")
        kernel_sm90.launch(q, k, v, out, True, D ** -0.5)
        e = bf16_errors(out, want, model, v)
        rows[name].update(ok=e["ok"], max_abs_err=e["max_abs"])
    B, S = 1, 8_192
    q, k, v = rnd((B, S, H, D)), rnd((B, S, K, D)), rnd((B, S, K, D))
    out = torch.empty(q.shape, device="cuda")
    names = list(libs)
    for order in (names, names[::-1]):
        for name in order:
            kernel_sm90._lib = libs[name]
            rows[name]["ms_runs"].append(cuda_ms(
                lambda: kernel_sm90.launch(q, k, v, out, True, D ** -0.5),
                args.reps))
    kernel_sm90._lib = None
    for row in rows.values():
        row["ms"] = sum(row["ms_runs"]) / len(row["ms_runs"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
