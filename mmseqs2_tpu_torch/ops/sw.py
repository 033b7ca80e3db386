"""Affine-gap Smith-Waterman scans: scores and end positions.

Port of the gapped entry points of mmseqs2_tpu/ops/pallas_sw.py. Every lane b
aligns the target in column b of `targets_t` against a query profile.

  sw_multi   `sw_pallas_multi`, the align stage's scan: lane b takes profile
             `qsel[b]` of NQ, confined to query rows >= `qoff[b]`.
  sw_single  `sw_pallas` (gapped): one (32, Lq) profile for every lane; the
             gapped exhaustive prefilter's scan.
  sw_offset  `sw_pallas_offset`: one profile and a per-lane `qoff`.
  sw_score   `sw_pallas_score`: one profile, the score alone (the max of H
             over all cells), without end tracking.

Each wrapper sends a CUDA tensor to the hand-written kernel (csrc/sw.cu,
built at first use: one kernel, instantiated with and without end tracking)
and a CPU tensor to its plain version (`sw_multi_plain`, `sw_single_plain`,
`sw_offset_plain`, `sw_score_plain`: batched column scans with the kernel's
exact semantics, on any device); anything else raises. `<wrapper>.launches`
counts that wrapper's kernel launches.

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


def sw_single_plain(profile, targets_t, go=11, ge=1):
    """Plain version of sw_single: sw_multi_plain at NQ = 1, qoff = 0."""
    zeros = torch.zeros(targets_t.shape[1], dtype=torch.int32,
                        device=profile.device)
    return sw_multi_plain(profile, targets_t, zeros, zeros, go, ge)


def sw_offset_plain(profile, targets_t, qoff, go=11, ge=1):
    """Plain version of sw_offset: sw_multi_plain at NQ = 1."""
    return sw_multi_plain(profile, targets_t, torch.zeros_like(qoff), qoff,
                          go, ge)


def sw_score_plain(profile, targets_t, go=11, ge=1):
    """Plain version of sw_score: the best H of the tracked scan."""
    return sw_single_plain(profile, targets_t, go, ge)[0]


def _launch_kernel(wrapper, prof_flat, targets_t, qsel, qoff, go, ge,
                   track=True):
    """Launch csrc/sw.cu for `wrapper` (whose count it raises). qsel None
    means profile 0 for every lane, qoff None offset 0; track False gives
    the score alone."""
    dev = prof_flat.device
    tensors = {"prof_flat": (prof_flat, torch.int32),
               "targets_t": (targets_t, torch.int8),
               "qsel": (qsel, torch.int32), "qoff": (qoff, torch.int32)}
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, prof_flat on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nqa, lq = prof_flat.shape
    lt, nb = targets_t.shape
    out = [torch.empty(nb, dtype=torch.int32, device=dev)
           for _ in range(3 if track else 1)]
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

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_multi_launch(
            prof_flat.data_ptr(), nqa // ALPHA_PAD, lq, targets_t.data_ptr(),
            lt, nb, ptr(qsel), ptr(qoff), int(go), int(ge), vec, strip,
            int(track), out[0].data_ptr(), ptr(out[1] if track else None),
            ptr(out[2] if track else None), ptr(hb), ptr(gb), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    wrapper.launches += 1
    return tuple(out)


def _on_cpu(name, prof_flat, *others):
    """True for CPU inputs, False for CUDA inputs; raises on anything else
    (no wrapper falls from the kernel to the plain version)."""
    dev = prof_flat.device
    if dev.type == "cpu":
        for t in others:
            if t is not None and t.device.type != "cpu":
                raise ValueError(f"{name}: inputs on mixed devices")
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


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
    if _on_cpu("sw_multi", prof_flat, targets_t, qsel, qoff):
        return sw_multi_plain(prof_flat, targets_t, qsel, qoff, go, ge)
    return _launch_kernel(sw_multi, prof_flat, targets_t, qsel, qoff, go, ge)


def _check_single(profile, targets_t, qoff, go, ge):
    if profile.dim() != 2 or profile.shape[0] != ALPHA_PAD:
        raise ValueError(f"profile must be ({ALPHA_PAD}, Lq), got "
                         f"{tuple(profile.shape)}")
    _check(profile, targets_t, None, qoff, go, ge)


def sw_single(profile, targets_t, go=11, ge=1):
    """(score, qend, tend) of one (32, Lq) profile against every lane of
    targets_t (Lt, B): mmseqs2_tpu's gapped sw_pallas."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_single", profile, targets_t):
        return sw_single_plain(profile, targets_t, go, ge)
    return _launch_kernel(sw_single, profile, targets_t, None, None, go, ge)


def sw_offset(profile, targets_t, qoff, go=11, ge=1):
    """sw_single with lane b confined to query rows >= qoff[b]
    (mmseqs2_tpu's sw_pallas_offset); qend in full-profile coordinates."""
    _check_single(profile, targets_t, qoff, go, ge)
    if _on_cpu("sw_offset", profile, targets_t, qoff):
        return sw_offset_plain(profile, targets_t, qoff, go, ge)
    return _launch_kernel(sw_offset, profile, targets_t, None, qoff, go, ge)


def sw_score(profile, targets_t, go=11, ge=1):
    """Scores alone, (B,) int32, without end tracking (mmseqs2_tpu's
    sw_pallas_score)."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_score", profile, targets_t):
        return sw_score_plain(profile, targets_t, go, ge)
    return _launch_kernel(sw_score, profile, targets_t, None, None, go, ge,
                          track=False)[0]


for _w in (sw_multi, sw_single, sw_offset, sw_score):
    _w.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("sw")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_multi_launch.argtypes = [p, i, i, p, i, i, p, p, i, i, i, i,
                                        i, p, p, p, p, p, p]
        lib.sw_multi_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
