#!/usr/bin/env python3
"""Build the wgmma flash kernel's instances in other designs and compare
each with the shipped one on the card, in one process.

    PYTHONPATH=src python tools/flash_sm90_variants.py [--part d240|small]
        [--reps 10] [--only shipped,stagger,...]

Each variant is a copy of ``csrc/flash_attention_sm90.cu`` whose
``Shape<D>`` lines are rewritten, built with nvcc under
``build/kernels/variants/`` and loaded in place of the package's library.
The variants of ``--part small`` other than ``shipped`` are built from a
copy with ``tools/flash_sm90_small_variants.patch`` applied first: the
switches the shipped kernel does not carry (BOX, OVERLAP, STAGGER, 256-key
tiles).

``--part d240`` (the default), gemma3-12b's head dim 240:

  shipped      no producer warp, the consumers reload the ring, up to 255
               registers a thread, one m64n240k16 P V wgmma a k-step
  producer_wg  a producer warpgroup (setmaxnreg 24 / 240, 384 threads), the
               same P V

``--part small``, head dims 16 and 32 (bound by the exponentials; each
variant rewrites both lines; NC consumer warpgroups beside a producer
warpgroup, BK keys a tile, CONSUMER_REGS through setmaxnreg):

  shipped           as the .cu stands: four consumer warpgroups and no
                    producer (128 registers a thread)
  nc3, nc3_stagger  three consumers (160 registers), the first design; and
                    each consumer warpgroup starting once the one before it
                    is through its first softmax (named barriers)
  box64             nc3 with 64-column boxes and the 128-byte swizzle (the
                    other instances' layout, zero columns past D), P V 64
                    wide
  nc2, nc4          two or four consumer warpgroups beside a producer (240 /
                    112 registers)
  nc4_stagger       four, staggered
  nc4_noprod_stagger  four and no producer warp (128 registers a thread,
                    the consumers reload the ring, as at D = 240),
                    staggered
  bk64_nc4, bk256_nc2, bk256_nc2_stagger  64-key tiles with four consumers,
                    256-key tiles with two (and staggered)
  overlap_nc2, overlap_nc3, overlap_bk64_nc4  FA3's intra-warpgroup overlap
                    (softmax of tile j beside P V of tile j - 1)

Every variant, ``shipped`` included, is built from a copy whose barrier
wait traps after ~2^31 clocks of waiting (the shipped wait traps after 2^26
polls, each of which may sleep), so that a design that deadlocks ends its
process instead of hanging the card; the wait's first poll, which a
running kernel takes, is the shipped one. For each: ptxas's registers and
spill bytes of each instance; the bf16 bar (``ref.bf16_errors`` with the
split's bound) against the plain version at ragged shapes (causal and not),
in a child process of its own; then, for the variants that met it, the
kernel's time at gemma3-12b's global-layer prefill shape (B=1, S=8,192,
H=16, K=8, bf16, causal) at each head dim of the part, timed in turns
(forward, then backward order) with SDPA bf16 on the same inputs in the
same turns. A variant that fails to build, to launch, to finish or the
bar is reported and left out of the timing. Prints one JSON line per
variant and the card's name, power limit and clocks. Needs the card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import nvcc_build
from repro_torch.kernels.flash_attention import (attention_bf16p_model,
                                                 attention_ref, kernel_sm90)
from repro_torch.kernels.flash_attention.ref import bf16_errors


def _small(nc, regs, bk, pv_n=None, box=None, overlap=0, stagger=0,
           producer=4):
    """Shape lines of D = 16 and 32 (by default with a producer warpgroup),
    4 stages."""
    return {d: f"NC = {nc},\n  PRODUCER_WARPS = {producer}, "
               f"CONSUMER_REGS = {regs}, "
               f"BK = {bk}, STAGES = 4, PV_N = {pv_n or d},\n"
               f"  BOX = {box or d}, OVERLAP = {overlap}, STAGGER = {stagger};"
            for d in (16, 32)}


PARTS = {
    "d240": {
        "shipped": None,
        "producer_wg": {240: "NC = 2,\n  PRODUCER_WARPS = 4, "
                             "CONSUMER_REGS = 240, BK = 64, STAGES = 2, "
                             "PV_N = 240;"},
    },
    # four consumers take 112 registers: a CTA of 640 threads launches with
    # 96 a thread, and the producer's 72 given up cover 16 more for each
    "small": {
        "shipped": None,
        "nc3": _small(3, 160, 128),
        "nc3_stagger": _small(3, 160, 128, stagger=1),
        "box64": _small(3, 160, 128, pv_n=64, box=64),
        "nc2": _small(2, 240, 128),
        "nc4": _small(4, 112, 128),
        "nc4_stagger": _small(4, 112, 128, stagger=1),
        "nc4_noprod_stagger": _small(4, 128, 128, stagger=1, producer=0),
        "bk64_nc4": _small(4, 112, 64),
        "bk256_nc2": _small(2, 240, 256),
        "bk256_nc2_stagger": _small(2, 240, 256, stagger=1),
        "overlap_nc2": _small(2, 240, 128, overlap=1),
        "overlap_nc3": _small(3, 160, 128, overlap=1),
        "overlap_bk64_nc4": _small(4, 112, 64, overlap=1),
    },
}
HEAD_DIMS = {"d240": (240,), "small": (16, 32)}
# ragged shapes held to the bar: (B, Sq, Sk, H, K, causal)
CHECKS = {"d240": [(1, 200, 200, 16, 8, True)],
          "small": [(1, 333, 333, 8, 2, True), (2, 37, 100, 4, 1, True),
                    (1, 100, 37, 6, 3, True), (2, 300, 300, 4, 2, False)]}


# the barrier wait's bound on polls, and the bounded wait of the variants
WAIT_BOUND = "if (n == (1u << 26)) __trap();"
WAIT_WATCHDOG = ("if (n == 0) t0 = clock64();\n"
                 "    else if (clock64() - t0 > (1ll << 31)) __trap();")
CHECK_TIMEOUT_S = 180
SWITCHES = Path(__file__).with_name("flash_sm90_small_variants.patch")


def apply_patch(src: str, patch: str) -> str:
    """``src`` with each hunk of the unified diff ``patch`` applied: the
    hunk's old lines (context and removed), found once in ``src``, become
    its new ones (context and added); line numbers are not read."""
    hunks = patch[patch.index("\n@@ ") + 1:].split("\n@@ ")
    for hunk in hunks:
        old, new = [], []
        for line in hunk.split("\n")[1:]:
            tag, text = line[:1], line[1:]
            if tag in (" ", "-"):
                old.append(text)
            if tag in (" ", "+"):
                new.append(text)
        old_s, new_s = "\n".join(old), "\n".join(new)
        assert src.count(old_s) == 1, f"a hunk of {SWITCHES.name} not found"
        src = src.replace(old_s, new_s)
    return src


def variant_source(part: str, name: str) -> Path:
    """The variant's source file: a copy of the package's (with the
    switches' patch, for the small part's variants) with the variant's
    Shape lines (none for ``shipped``) and the watchdog wait."""
    src = kernel_sm90.SOURCE.read_text()
    if part == "small" and name != "shipped":
        src = apply_patch(src, SWITCHES.read_text())
    assert src.count(WAIT_BOUND) == 1, "the barrier wait's bound"
    src = src.replace(WAIT_BOUND, WAIT_WATCHDOG).replace(
        "  for (uint32_t n = 0;; ++n) {",
        "  long long t0 = 0;\n  for (uint32_t n = 0;; ++n) {", 1)
    for d, fields in (PARTS[part][name] or {}).items():
        src, n = re.subn(rf"template <> struct Shape<{d}> \{{[^}}]*\}};",
                         f"template <> struct Shape<{d}> {{ static "
                         f"constexpr int {fields} }};", src)
        assert n == 1, f"Shape<{d}> not found in the source"
    path = (nvcc_build.BUILD_DIR / "variants" / f"{part}_{name}"
            / kernel_sm90.SOURCE.name)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
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


def _build(part: str, name: str):
    """(library path, ptxas usage by head dim) or the build's error."""
    try:
        path = nvcc_build.build_library(variant_source(part, name),
                                        verbose=True)
    except RuntimeError as e:
        return None, str(e)[-2000:]
    report = nvcc_build.report_path(path).read_text()
    usage = {d: [u for u in nvcc_build.ptxas_usage(report)
                 if kernel_sm90.instance_name(d) in u["kernel"]][0]
             for d in HEAD_DIMS[part]}
    return path, usage


def rnd(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def check(part: str, path: Path) -> list:
    """The bar at the part's ragged shapes for the library at ``path``."""
    kernel_sm90._lib = _load(path)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out_rows = []
    for D in HEAD_DIMS[part]:
        for B, Sq, Sk, H, K, causal in CHECKS[part]:
            q = rnd(gen, (B, Sq, H, D))
            k, v = rnd(gen, (B, Sk, K, D)), rnd(gen, (B, Sk, K, D))
            want = attention_ref(q, k, v, causal)
            model = attention_bf16p_model(q, k, v, causal)
            out = torch.empty(q.shape, device="cuda")
            kernel_sm90.launch(q, k, v, out, causal, D ** -0.5)
            torch.cuda.synchronize()
            out_rows.append({"D": D, "shape": [B, Sq, Sk, H, K],
                             "causal": causal,
                             **bf16_errors(out, want, model, v)})
    return out_rows


def check_in_child(part: str, path: Path) -> tuple[bool, object]:
    """:func:`check` in a process of its own (a trap ends only that
    process's context): (whether every case met the bar, the cases or the
    failure)."""
    try:
        res = subprocess.run([sys.executable, __file__, "--check", part,
                              str(path)], capture_output=True, text=True,
                             timeout=CHECK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return False, f"no result within {CHECK_TIMEOUT_S} s"
    if res.returncode != 0:
        return False, res.stderr[-1500:]
    cases = json.loads(res.stdout.strip().splitlines()[-1])
    return all(c["ok"] for c in cases), cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=sorted(PARTS), default="d240")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", help="comma-separated variants to run")
    ap.add_argument("--check", nargs=2, metavar=("PART", "LIBRARY"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_sm90_variants: needs a CUDA device")
    if args.check:
        print(json.dumps(check(args.check[0], Path(args.check[1]))))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    part, dims = args.part, HEAD_DIMS[args.part]
    names = args.only.split(",") if args.only else list(PARTS[part])
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: _build(part, n), names)))
    libs, rows = {}, {}
    for name, (path, usage) in built.items():
        rows[name] = {"variant": name, "part": part}
        if path is None:
            rows[name]["build_error"] = usage
        else:
            rows[name]["ptxas"] = usage
            ok, cases = check_in_child(part, path)
            rows[name].update(ok=ok, checks=cases)
            if ok:
                libs[name] = _load(path)
        print(json.dumps({k: v for k, v in rows[name].items()
                          if k != "checks"}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, K = 1, 8_192, 16, 8
    rows["sdpa"] = {"variant": "sdpa", "part": part}
    for D in dims:
        q = rnd(gen, (B, S, H, D))
        k, v = rnd(gen, (B, S, K, D)), rnd(gen, (B, S, K, D))
        out = torch.empty(q.shape, device="cuda")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            from torch.nn.attention import SDPBackend, sdpa_kernel
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        order = list(libs) + ["sdpa"]
        for turn in (order, order[::-1]):
            for name in turn:
                if name == "sdpa":
                    t = cuda_ms(sdpa, args.reps)
                else:
                    kernel_sm90._lib = libs[name]
                    t = cuda_ms(lambda: kernel_sm90.launch(
                        q, k, v, out, True, D ** -0.5), args.reps)
                rows[name].setdefault(f"ms_runs_d{D}", []).append(t)
        del q, k, v, out, qt, kt, vt
    kernel_sm90._lib = None
    for row in rows.values():
        for D in dims:
            runs = row.get(f"ms_runs_d{D}")
            if runs:
                row[f"ms_d{D}"] = sum(runs) / len(runs)
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
