"""Multi-query affine-gap Smith-Waterman: scores and end positions.

Port of `sw_pallas_multi` (mmseqs2_tpu/ops/pallas_sw.py), the align stage's
device scan: every lane b aligns the target in column b of `targets_t`
against query profile `qsel[b]`, confined to query rows >= `qoff[b]`.

  sw_multi        the wrapper: a CUDA tensor goes to the hand-written kernel
                  (csrc/sw.cu, built at first use), a CPU tensor to the plain
                  version; anything else raises. `sw_multi.launches` counts
                  kernel launches.
  sw_multi_plain  the plain PyTorch version: a batched column scan with the
                  kernel's exact semantics, on any device.

Semantics (those of the TPU kernel): affine gaps, a gap of length k costs
go + (k-1)*ge with go >= ge; E reads the previous column's H after the lazy-F
correction; the score is the best H; the target end is the first column
reaching it and the query end the smallest row attaining it in that column.
A lane whose scores are all <= 0 gives (0, lq - 1, -1). The query end is in
full-profile coordinates (the caller subtracts qoff).
"""

import ctypes

import torch

ALPHA_PAD = 32
NEG_INF = -(1 << 28)
MAX_STRIP = 32          # query rows per thread; a warp covers 32 * 32 rows


def sw_multi_plain(prof_flat, targets_t, qsel, qoff, go=11, ge=1):
    """Plain version of sw_multi, column by column over the target axis.

    prof_flat: (NQ*32, Lq) int32, query q's substitution rows at
    [q*32, (q+1)*32); targets_t: (Lt, B) integer letters in [0, 32);
    qsel, qoff: (B,) int32. Returns (score, qend, tend), each (B,) int32."""
    dev = prof_flat.device
    i32 = torch.int32
    lq = prof_flat.shape[1]
    lt, nb = targets_t.shape
    prof = prof_flat.to(i32)
    rows = torch.arange(lq, device=dev, dtype=i32)
    ramp = rows * ge                        # G[k] = Hng[k] + k*ge
    fconst = -go - (rows - 1) * ge          # F[i] = max_{k<i} G[k] + fconst[i]
    base = qsel.to(torch.int64) * ALPHA_PAD
    offmask = torch.where(rows[None, :] < qoff.to(i32)[:, None],
                          NEG_INF, 0).to(i32)
    H = torch.zeros((nb, lq), dtype=i32, device=dev)
    E = torch.full((nb, lq), NEG_INF, dtype=i32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=i32, device=dev)
    neg_col = torch.full((nb, 1), NEG_INF, dtype=i32, device=dev)
    best = torch.zeros(nb, dtype=i32, device=dev)
    qend = torch.full((nb,), lq - 1, dtype=i32, device=dev)
    tend = torch.full((nb,), -1, dtype=i32, device=dev)
    letters = targets_t.to(torch.int64)
    for j in range(lt):
        s = prof[base + letters[j]] + offmask
        diag = torch.cat([zero_col, H[:, :-1]], 1) + s
        E = torch.maximum(H - go, E - ge)
        hng = torch.maximum(diag, E).clamp_(min=0)
        run = torch.cummax(hng + ramp, 1).values
        H = torch.maximum(hng, torch.cat([neg_col, run[:, :-1]], 1) + fconst)
        colmax, amax = H.max(1)             # amax: first row attaining it
        better = colmax > best
        tend = torch.where(better, j, tend)
        qend = torch.where(better, amax.to(i32), qend)
        best = torch.maximum(best, colmax)
    return best, qend, tend


def _check(prof_flat, targets_t, qsel, qoff, go, ge):
    if prof_flat.dim() != 2 or prof_flat.shape[0] % ALPHA_PAD \
            or prof_flat.shape[0] == 0 or prof_flat.shape[1] == 0:
        raise ValueError(f"prof_flat must be (NQ*{ALPHA_PAD}, Lq) with "
                         f"NQ, Lq >= 1, got {tuple(prof_flat.shape)}")
    if targets_t.dim() != 2:
        raise ValueError(f"targets_t must be (Lt, B), got "
                         f"{tuple(targets_t.shape)}")
    nb = targets_t.shape[1]
    for name, t in (("qsel", qsel), ("qoff", qoff)):
        if t is not None and tuple(t.shape) != (nb,):
            raise ValueError(f"{name} must be ({nb},), got {tuple(t.shape)}")
    if not 0 <= int(ge) <= int(go):
        raise ValueError(f"need 0 <= gap_extend <= gap_open, got go={go} "
                         f"ge={ge}")


def _launch_kernel(prof_flat, targets_t, qsel, qoff, go, ge):
    dev = prof_flat.device
    tensors = {"prof_flat": (prof_flat, torch.int32),
               "targets_t": (targets_t, torch.int8),
               "qsel": (qsel, torch.int32), "qoff": (qoff, torch.int32)}
    for name, (t, dtype) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, prof_flat on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nqa, lq = prof_flat.shape
    lt, nb = targets_t.shape
    out = [torch.empty(nb, dtype=torch.int32, device=dev) for _ in range(3)]
    if nb == 0:
        return tuple(out)
    strip = 1
    while strip < MAX_STRIP and 32 * strip < lq:
        strip *= 2
    hb = gb = None
    if lq > 32 * strip:         # strip-mined long query: boundary scratch
        hb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
        gb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
    vec = int(lq % 4 == 0 and prof_flat.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_multi_launch(
            prof_flat.data_ptr(), nqa // ALPHA_PAD, lq, targets_t.data_ptr(),
            lt, nb, qsel.data_ptr(), qoff.data_ptr(), int(go), int(ge), vec,
            strip, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            hb.data_ptr() if hb is not None else None,
            gb.data_ptr() if gb is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"sw_multi kernel launch failed: CUDA error {err}")
    sw_multi.launches += 1
    return tuple(out)


def sw_multi(prof_flat, targets_t, qsel, qoff=None, go=11, ge=1):
    """Scores and end positions of many (query profile, target) lanes.

    Same arguments and layout as mmseqs2_tpu's sw_pallas_multi, as torch
    tensors: prof_flat (NQ*32, Lq) int32, targets_t (Lt, B) int8 (pad letter
    31), qsel and qoff (B,) int32 (qoff None means 0). Profile scores must
    lie within +-(1 << 20). Returns (score, qend, tend) (B,) int32 on the
    inputs' device."""
    _check(prof_flat, targets_t, qsel, qoff, go, ge)
    if qoff is None:
        qoff = torch.zeros_like(qsel)
    dev = prof_flat.device
    if dev.type == "cpu":
        for t in (targets_t, qsel, qoff):
            if t.device.type != "cpu":
                raise ValueError("sw_multi: inputs on mixed devices")
        return sw_multi_plain(prof_flat, targets_t, qsel, qoff, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"sw_multi: no kernel for device {dev}")
    return _launch_kernel(prof_flat, targets_t, qsel, qoff, go, ge)


sw_multi.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("sw")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_multi_launch.argtypes = [p, i, i, p, i, i, p, p, i, i, i, i,
                                        p, p, p, p, p, p]
        lib.sw_multi_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
