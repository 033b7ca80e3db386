"""Build and load the port's CUDA kernels at first use.

A source `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (sm_90a) into a shared library under the package's
git-ignored build directory, keyed by a hash of the source, the headers of
`csrc/` and the flags,
then loaded with ctypes. Nothing is built when a module is imported: a CPU
run never reaches this module. A missing `nvcc` or a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .. import BUILD_DIR, PACKAGE_DIR

CSRC = PACKAGE_DIR / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
        path = cand if CUDA_HOME and os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled from "
            "csrc/ at first use; put the CUDA toolkit's nvcc on PATH or "
            "set CUDA_HOME")
    return path


def library_path(name: str):
    """The library of csrc/<name>.cu, keyed by the source, every header of
    csrc/ (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless it is built already. Returns nvcc's
    output (the ptxas report), or "" when nothing was built."""
    so = library_path(name)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, so)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
