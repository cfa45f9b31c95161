"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain ``extern "C"`` launcher (no PyTorch headers, so no
``ninja`` and a build of seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

Libraries go to ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
not.  The ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside each
library as ``<lib>.log``.  Nothing is fetched: the sources are the
repository's own.  No library beyond the CUDA runtime is linked: the
tensor-core attention kernel looks up libcuda's ``cuTensorMapEncodeTiled``
through ``cudaGetDriverEntryPoint``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("quantize_tiles", "quantize_ef", "topk_mask",
                  "flash_attention", "flash_attention_wgmma")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` of PyTorch's CUDA home (``$CUDA_HOME``, else the one on the
    PATH, else the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return str(nvcc)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = [(n, *_start(n)) for n in todo]
    errors = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)      # atomic: safe against a concurrent build
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's report for the built library of ``name``, if any."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = build_all((name,))[name]
    lib = _LOADED.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        _LOADED[path] = lib
    return lib
