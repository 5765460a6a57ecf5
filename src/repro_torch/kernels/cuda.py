"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source under ``repro_torch/kernels/<family>/`` is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``.  Builds happen at first
use, from the checkout's sources only, into ``<family>/build/`` (listed
in ``.gitignore``); the library name carries a hash of the sources and
flags, so an edited kernel is rebuilt, never reused stale.  Nothing here
runs at import time.

Every kernel wrapper calls :func:`count_launch` right where it launches
its kernel, so a run can show which kernels its main path went through.
Each build and each library load is also counted in the observability
registry (``obs.dispatch.record_kernel_build`` / ``record_module_load``)
while a session is installed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from repro_torch.obs.dispatch import record_kernel_build, record_module_load

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS_DIR = Path(__file__).resolve().parent

_LIBS: Dict[Path, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return found


def all_sources() -> list[Path]:
    """Every kernel source of the port (``kernels/*/csrc/*.cu``)."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return src.parent.parent / "build" / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> Dict[Path, Path]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{source: library path}``; raises with
    the compiler's output when a build fails.  The ptxas report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    out, procs = {}, []
    for src in sources:
        lib = _library_path(Path(src))
        out[Path(src)] = lib
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, lib)
        record_kernel_build(src.name)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def build_all() -> float:
    """Build every kernel source of the port; returns the wall seconds."""
    t0 = time.perf_counter()
    build(all_sources())
    return time.perf_counter() - t0


def library(src: Path, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``src`` (built on first use), with
    ``argtypes`` set from ``signatures`` ({function: [ctypes types]}) and
    ``restype`` int (a ``cudaError_t``) for each."""
    lib = _LIBS.get(src)  # callers pass their module's Path: no parse
    if lib is None:
        src = Path(src)
        lib = ctypes.CDLL(str(build([src])[src]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[src] = lib
        record_module_load(src.name)
    return lib


_SMEM_LIMITS: Dict[tuple, int] = {}


def raise_smem(lib: ctypes.CDLL, setter: str, which: int, smem: int,
               device: torch.device) -> None:
    """Let kernel ``which`` of ``lib`` take ``smem`` bytes of dynamic
    shared memory on ``device``: ``lib.<setter>(which, smem)`` (a
    ``cudaFuncSetAttribute``), called only when ``smem`` exceeds the
    limit already set, rather than before every launch.  The limit only
    grows: it bounds every later launch of the kernel, so lowering it
    would refuse a larger launch that found its size already set."""
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    key = (setter, which, index)
    if smem <= _SMEM_LIMITS.get(key, -1):
        return
    with torch.cuda.device(index):
        check(getattr(lib, setter)(which, smem), setter)
    _SMEM_LIMITS[key] = smem


def check(err: int, name: str) -> None:
    """Raise if a launch (or its shared-memory attribute call) failed."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {err}"
        )


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer (read
    without building a ``torch.cuda.Stream``: this runs every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Check a kernel operand: CUDA, dtype, shape and contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
