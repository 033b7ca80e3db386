"""Native (C) helpers of the profile stack, built at first use with the
host's C compiler.

They cover the reference code paths whose float results depend on x86
instruction semantics: the rcpps approximation in the PSSM's
position-specific weights and the SSE dot-product reduction tree of its
pseudocounts (see pssm_kernels.c). The library is built into the port's
git-ignored build directory, keyed by a hash of the source and the flags,
and nothing is written into the package. There is no numpy fallback: a
fallback differs from the reference by an ulp in rare cells, which changes
a profile byte, so a missing compiler or a failed build raises with the
compiler's output. The source uses SSE intrinsics: a host that is not
x86-64 cannot build it, and the error says so.
"""

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "pssm_kernels.c"
CFLAGS = ["-O3", "-march=native", "-fsigned-char", "-shared", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()


def library_path():
    """The library's path in the build directory, keyed by the source and
    the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"pssm_kernels_{h.hexdigest()[:16]}.so"


def _build(so):
    if platform.machine().lower() not in ("x86_64", "amd64"):
        raise RuntimeError(
            f"native/pssm_kernels.c uses x86 SSE intrinsics (rcpps and the "
            f"reference's SSE dot product); this host is "
            f"{platform.machine()}, so the profile stack cannot reproduce "
            f"the reference's PSSM bytes here")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: concurrent processes never load
    # a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, *CFLAGS, str(SOURCE), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, so)
            return
        errors.append(f"{cc}: {r.stderr.strip()}")
    raise RuntimeError("cannot build native/pssm_kernels.c, which the "
                       "profile stack needs for the reference's PSSM "
                       "bytes:\n" + "\n".join(errors))


def get_lib():
    """Build (once) and return the ctypes library; raises if it cannot be
    built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            p = ctypes.c_void_p
            lib.nr_rcp_batch.argtypes = [p, p, ctypes.c_long]
            lib.nr_rcp_batch.restype = None
            lib.scalar_prod20_batch.argtypes = [p, p, p, ctypes.c_long]
            lib.scalar_prod20_batch.restype = None
            _LIB = lib
        return _LIB


def nr_rcp(values):
    """x86 rcpps + one Newton-Raphson iteration, elementwise (float32)."""
    lib = get_lib()
    x = np.ascontiguousarray(values, dtype=np.float32)
    out = np.empty_like(x)
    lib.nr_rcp_batch(x.ctypes.data, out.ctypes.data, x.size)
    return out.reshape(np.shape(values))


def scalar_prod20(R, freq):
    """out[p, aa] = the reference's ScalarProd20(R[aa], freq[p])."""
    lib = get_lib()
    Rf = np.ascontiguousarray(R, dtype=np.float32)
    f = np.ascontiguousarray(freq, dtype=np.float32)
    if Rf.shape != (20, 20) or f.ndim != 2 or f.shape[1] != 20:
        raise ValueError(f"scalar_prod20 takes R (20, 20) and freq (n, 20), "
                         f"got {Rf.shape} and {f.shape}")
    out = np.empty((f.shape[0], 20), dtype=np.float32)
    lib.scalar_prod20_batch(Rf.ctypes.data, f.ctypes.data, out.ctypes.data,
                            f.shape[0])
    return out
