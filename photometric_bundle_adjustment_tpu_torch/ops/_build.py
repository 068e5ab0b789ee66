"""Builds the CUDA sources in ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout, then loaded with ctypes.  The hash covers the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
A missing ``nvcc``, a failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every source of csrc/, in the order chip_smoke.py prints their builds
SOURCES = ("pba_mega", "hamming", "patch_sample", "grid_overhead",
           "exp_roll", "mma_rate")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc output) for the builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use; put "
        "nvcc on PATH or set CUDA_HOME"
    )


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(path))
    _LIBS[name] = lib
    return lib


def load_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """``load`` every source in ``names`` (all of ``SOURCES`` by default),
    the nvcc runs started together (one process each); raises the first
    failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(load, n) for n in names]
        return {n: f.result() for n, f in zip(names, futures)}
