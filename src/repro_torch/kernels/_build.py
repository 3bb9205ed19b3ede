"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the repository root. The library's
file name carries a hash of its sources and flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: the first kernel call builds what it needs, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
KERNELS = ("pdist_argmin", "kmeans_update", "solve_attach", "moe_dispatch",
           "moe_combine", "swa_decode", "moe_combine_bwd",
           "moe_dispatch_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc (the CUDA compiler) was not found: set "
                       "CUDA_HOME or put nvcc on the PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library among ``names``, one ``nvcc``
    process per source, all at once. Returns {name: (seconds, compiler
    log)} for what was built; raises with the log if a build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    built, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def require(name: str, arg: str, t, dtypes, ndims) -> None:
    """Refuse an operand the kernel does not take: not a CUDA tensor,
    another dtype or rank, or not contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {arg} must be a CUDA tensor (got "
                         f"{t.device}); CPU tensors take the plain "
                         f"version in kernels/ref.py")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {arg} has dtype {t.dtype}, the kernel "
                         f"takes {list(dtypes)}")
    if t.dim() not in ndims:
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, the "
                         f"kernel takes {sorted(ndims)} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (cudaError_t != 0)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")
