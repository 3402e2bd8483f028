"""Build and load the port's hand-written CUDA kernels.

Each kernel source (``<module>/csrc/<name>.cu``, for the modules
``compress``, ``fused_ef`` and ``topk_select``) is compiled by ``nvcc``
into a shared library with a plain C interface (route (b) of building a
kernel: no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. A library is built at first use from the checkout's own
sources into ``<repo>/build/kernels`` (listed in ``.gitignore``), under a
name keyed by a hash of its source, the headers of its directory and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source at once and waits for all of
them.

Nothing here runs at import time: the CPU tests import every module and
this sandbox has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# library name -> the kernel module whose csrc/ holds <name>.cu
SOURCES = {"sweep1": "compress", "sweep2": "compress",
           "sketch_parts": "compress", "fused_ef": "fused_ef",
           "hist": "topk_select"}


def csrc(name: str) -> Path:
    return KERNELS / SOURCES[name] / "csrc"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from src/repro_torch/kernels/*/csrc at "
                           "first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    src = csrc(name)
    for part in sorted(src.glob("*.cuh")) + [src / f"{name}.cu"]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns {name: ptxas
    report} for the ones compiled here (empty report when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               str(csrc(name) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)            # atomic: concurrent builders agree
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``<module>/csrc/<name>.cu``, built first if
    needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))
