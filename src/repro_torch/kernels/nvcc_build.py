"""Build a kernel's CUDA source with ``nvcc`` and load it with ``ctypes``.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C entry
point. :func:`build_library` compiles it for ``sm_90a`` into a shared
library under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named after the source's stem and a hash of its bytes and
the flags, so an edited source builds anew and an unchanged one is reused.
The library is written to a temporary name and renamed into place, so
concurrent builds of one source never see a half-written file. A verbose
build writes the compiler's report (``-Xptxas -v``: registers, spills)
beside the library (:func:`report_path`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build_library(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` (skipped when the library for these exact bytes
    and flags exists and, if ``verbose``, so does its report) and return the
    library's path. ``verbose`` adds ``-Xptxas -v``, keeps the compiler's
    report beside the library and prints it."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists() and not verbose:
        return out
    if out.exists() and report_path(out).exists():
        print(report_path(out).read_text(), end="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    if verbose:
        report_path(out).write_text(res.stderr)
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out


def report_path(library: Path) -> Path:
    """Where a verbose build of ``library`` left ptxas's report."""
    return library.with_suffix(".ptxas.txt")


def load_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load the library."""
    return ctypes.CDLL(str(build_library(source)))


def ptxas_usage(report: str) -> list[dict]:
    """Per kernel of a ``-Xptxas -v`` report: its (mangled) name, registers,
    stack frame and spill bytes."""
    out = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        nums = [int(g) for g in spill.groups()] if spill else [None] * 3
        out.append({"kernel": name,
                    "registers": int(regs.group(1)) if regs else None,
                    "stack_bytes": nums[0], "spill_store_bytes": nums[1],
                    "spill_load_bytes": nums[2]})
    return out
