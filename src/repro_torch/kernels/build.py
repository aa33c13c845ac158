"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on
first use by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own
shared library, which is loaded with ``ctypes``.  Libraries land in
``build/repro_torch_kernels/`` at the repository root, named by a hash
of the source, the ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the GPU")


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what a source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.source = tmp, out, source
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {proc.source.name}:\n{log}")
    os.replace(proc.tmp, proc.out)
    return log


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built."""
    out = _target(source)
    if not out.exists():
        _finish(_start(source, out))
    return out


def build_all(sources: Optional[Sequence[Path]] = None) -> Dict[str, str]:
    """Build every kernel source in parallel (one nvcc each).  Returns
    ``{source name: nvcc log}`` (the ``-Xptxas -v`` register and shared
    memory report) for the sources that were compiled."""
    sources = list(sources or sorted(CSRC.glob("*.cu")))
    procs: List[subprocess.Popen] = []
    for src in sources:
        out = _target(src)
        if not out.exists():
            procs.append(_start(src, out))
    logs = {}
    try:
        for p in procs:
            logs[p.source.name] = _finish(p)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


class CudaKernel:
    """One kernel's C entry point plus its launch count.

    ``launch`` calls the C function (which launches on the given stream
    and returns ``cudaGetLastError()``), raises if that is not 0, and
    only then adds one to ``launches`` and, when the wrapper names the
    launch's ``shape``, one to ``shapes[shape]``."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.shapes: Counter = Counter()
        self._fn = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def library(self) -> ctypes.CDLL:
        """The loaded library (built on first use), for its other
        entry points."""
        self._load()
        return self._lib

    def launch(self, *args, shape: Optional[tuple] = None) -> None:
        err = self._load()(*args)
        if err != 0:
            msg = self._lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} "
                               f"({msg})")
        self.launches += 1
        if shape is not None:
            self.shapes[shape] += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
