"""Build a kernel's CUDA source with ``nvcc`` and load it with ``ctypes``.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C entry
point. :func:`build_library` compiles it for ``sm_90a`` into a shared
library under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named after the source's stem and a hash of its bytes and
the flags, so an edited source builds anew and an unchanged one is reused.
The library is written to a temporary name and renamed into place, so
concurrent builds of one source never see a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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
    and flags exists) and return the library's path. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists():
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
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out


def load_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load the library."""
    return ctypes.CDLL(str(build_library(source)))
