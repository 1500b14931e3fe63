"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/repro_torch_kernels/<name>-<hash>.so`` in the checkout, at
first use.  All sources are compiled together, one nvcc process each, so the
build takes as long as the slowest file.  The hash covers the source and the
flags, so an edited kernel is rebuilt and a stale library is never loaded.

Nothing here runs at import: the tests import every module, also on hosts
without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# path codes of csrc/common.cuh: the kernel a wrapper asks its entry point for
PATHS = ("simt", "wgmma", "wmma", "split", "vector")

_LIBS: Dict[str, ctypes.CDLL] = {}
build_log: List[str] = []       # nvcc's output (ptxas register/smem report)
build_seconds: float = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every csrc/*.cu whose library is missing, all in parallel."""
    global build_seconds
    todo: List[Tuple[Path, Path]] = [
        (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))
        if not _target(src).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log.append(f"== nvcc {src.name} (rc {p.returncode})\n{log}")
        if p.returncode == 0:
            os.replace(tmp, out)          # atomic: a racing build is harmless
        else:
            failed.append(f"{src.name}:\n{log}")
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(CSRC / f"{name}.cu")
        if not target.exists():
            build_all()
        lib = ctypes.CDLL(str(target))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def entry(name: str, fn_name: str, argtypes: list):
    """C entry point ``fn_name`` of library ``name``, returning an int error
    code; ``argtypes`` must use c_void_p for every pointer and the stream, or
    ctypes cuts them to 32 bits."""
    fn = getattr(library(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def count_launch(fn, path: str) -> None:
    """Count one launch of wrapper ``fn``, on kernel ``path``."""
    fn.launches += 1
    fn.launches_by_path[path] += 1


def reset_counts(fn) -> None:
    """Set a wrapper's launch count, and its count per path if it keeps one,
    to 0."""
    fn.launches = 0
    if hasattr(fn, "launches_by_path"):
        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def check(name: str, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point of ``name``."""
    if err:
        msg = library(name).error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
