"""Ungapped diagonal rescore of prefilter candidates (exact scores).

Port of the k-mer prefilter's rescorer (mmseqs2_tpu/prefilter:
pallas_rescore.py:_kernel, device_stages.make_rescore and
make_rescore_from_letters, driven by _chunked_rescore; reference
UngappedAlignment.cpp): for every valid candidate (query qid, target id,
diagonal) the score of the best ungapped segment on that diagonal,

    d  = the low 16 bits of diag read as signed; qs = max(d, 0); ts = max(-d, 0)
    n  = max(min(t_len[id] - ts, q_len[qid] - qs), 0)
    s_l = submat[q[qid, qs + l], t_cat[t_off[id] + ts + l]] + corr[qid, qs + l]
    out = max(0, max_l (c_l - min(0, min_{k<l} c_k))),  c = cumsum(s)

and 0 for an invalid candidate, a slot at or past the valid count, or an
empty window. The score is exact (int32); the caller takes min(score, 255)
where the reference caps.

The profile form (B4', for profile queries; the JAX package's
device_stages.make_rescore under _device_match) changes only the cell score:

    s_l = prof[qid, qs + l, t_cat[t_off[id] + ts + l]]

with prof (B, Lq, 32) int8, each query position's row padded to 32 bytes.

  diag_rescore        the wrapper: CUDA tensors go to the hand-written kernel
                      (csrc/rescore.cu, built at first use), CPU tensors to the
                      plain version; anything else raises.
                      `diag_rescore.launches` counts kernel launches.
  diag_rescore_plain  the same function in plain PyTorch (gather, cumsum,
                      cummin), on any device.
  window_cells        the cells of each slot's window (-1: no candidate).
  diag_rescore_profile, diag_rescore_profile_plain
                      the profile form's wrapper (its own `launches`, its
                      own kernel) and plain version.
  profile_rows        packs a query's integer (L, A) rescore profile into the
                      int8 (L, 32) rows the profile form reads; raises on a
                      value outside int8 (never clamps).

Tensors: cqid, cid, cdiag (C,) int32 and cvalid (C,) bool; t_cat (R,) int8
target letters, t_off (T,) int64 and t_len (T,) int32; q_pad (B, Lq) uint8
query letters and corr (B, Lq) int8 bias correction; submat (A, A) int32 with
A <= 32; q_len (B,) int32. Slots with cvalid False may hold any qid and id.

The valid count, `n_valid` (optional): a 0-dim or (1,) int32 tensor on the
candidates' device holding the count of front-compacted valid slots, as the
reference's n_valid. Slots at and past it give 0 whatever cvalid says; slots
before it obey cvalid. The kernel reads it on the card, so a flush that
passes its device-side candidate count never waits for it: the kernel's
grid is sized to the card, its warps take the slots below the count by a
grid-stride loop, and the slots past it are zero-filled.

The kernel (csrc/rescore.cu's header has the whole design): a group of 8
lanes takes a candidate, each lane scores 16 consecutive cells of the
window into a summary (sum, largest prefix sum, Kadane state and best), and
the group combines the summaries with one exclusive sum-scan and one
min-scan per 128 cells; the target bytes, query letters and corrections
come in as aligned words. All int32: the bound is
set by bytes, not operations, and a window's running sum can pass int16.

The profile form's kernel (its own, rescore_profile_kernel) runs the same
body and differs only in how a lane gets its run's 16 scores: it reads
them from their 16 profile rows at once, as soon as the pass's target
letters are in. The path hands it slots sorted by (query, target), so a
block reads the rows of a few queries and they stay in L1.
"""

import ctypes

import numpy as np
import torch

MAX_ALPHA = 32
PROFILE_WIDTH = 32      # bytes of a profile row: one 32-byte sector
PLAIN_ROWS = 2048       # candidates per gather block of the plain version

_SPEC = (("cqid", torch.int32, 1), ("cid", torch.int32, 1),
         ("cdiag", torch.int32, 1), ("cvalid", torch.bool, 1),
         ("t_cat", torch.int8, 1), ("t_off", torch.int64, 1),
         ("t_len", torch.int32, 1), ("q_pad", torch.uint8, 2),
         ("corr", torch.int8, 2), ("submat", torch.int32, 2),
         ("q_len", torch.int32, 1))


_PROFILE_SPEC = _SPEC[:7] + (("prof", torch.int8, 3),
                             ("q_len", torch.int32, 1))


def _check_tensors(spec, args):
    dev = args[0].device
    for (name, dtype, dim), t in zip(spec, args):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cqid on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimension(s), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cqid, cid, cdiag, cvalid, _, t_off, t_len = args[:7]
    n = cqid.shape[0]
    for name, t in (("cid", cid), ("cdiag", cdiag), ("cvalid", cvalid)):
        if t.shape[0] != n:
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if t_off.shape != t_len.shape:
        raise ValueError("t_off and t_len must have one entry per target")


def _check(args, n_valid=None):
    _check_tensors(_SPEC, args)
    q_pad, corr, submat, q_len = args[7:]
    if corr.shape != q_pad.shape or q_len.shape[0] != q_pad.shape[0]:
        raise ValueError("q_pad, corr must be (B, Lq) and q_len (B,)")
    if submat.shape[0] != submat.shape[1] or not \
            1 <= submat.shape[0] <= MAX_ALPHA:
        raise ValueError(f"submat must be (A, A) with A <= {MAX_ALPHA}, got "
                         f"{tuple(submat.shape)}")
    _check_n_valid(n_valid, args[0].device)


def _check_profile(args, n_valid=None):
    _check_tensors(_PROFILE_SPEC, args)
    prof, q_len = args[7:]
    if prof.shape[2] != PROFILE_WIDTH or q_len.shape[0] != prof.shape[0]:
        raise ValueError(f"prof must be (B, Lq, {PROFILE_WIDTH}) and q_len "
                         f"(B,), got {tuple(prof.shape)} and "
                         f"{tuple(q_len.shape)}")
    _check_n_valid(n_valid, args[0].device)


def _check_n_valid(n_valid, dev):
    if n_valid is None:
        return
    if not isinstance(n_valid, torch.Tensor):
        raise TypeError("n_valid must be a tensor on the candidates' device")
    if n_valid.device != dev:
        raise ValueError(f"n_valid is on {n_valid.device}, cqid on {dev}")
    if n_valid.dtype != torch.int32:
        raise TypeError(f"n_valid must be {torch.int32}, got "
                        f"{n_valid.dtype}")
    if n_valid.numel() != 1 or n_valid.dim() > 1:
        raise ValueError(f"n_valid must be 0-dim or (1,), got "
                         f"{tuple(n_valid.shape)}")


def _window(qid, tid, cdiag, t_len, q_len):
    """(qs, ts, n) int64 of each candidate's window."""
    d = ((cdiag.long() + 0x8000) & 0xFFFF) - 0x8000          # signed 16 bits
    qs = d.clamp(min=0)
    ts = (-d).clamp(min=0)
    n = torch.minimum(t_len[tid].long() - ts,
                      q_len[qid].long() - qs).clamp(min=0)
    return qs, ts, n


def window_cells(cqid, cid, cdiag, cvalid, t_len, q_len, n_valid=None):
    """(C,) int64: the cells of each slot's window, -1 for a slot that is
    no candidate (invalid, or at or past n_valid). Reads nothing back to the
    host."""
    if n_valid is not None:
        cvalid = cvalid & (torch.arange(cqid.shape[0], device=cqid.device)
                           < n_valid.reshape(()))
    qid = torch.where(cvalid, cqid, 0).long()
    tid = torch.where(cvalid, cid, 0).long()
    return torch.where(cvalid, _window(qid, tid, cdiag, t_len, q_len)[2], -1)


def _plain(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_len, n_valid,
           lq, cell):
    """The max-subarray of every valid slot's window, in blocks of
    PLAIN_ROWS candidates, each as wide as its longest window.
    cell(tc, qrow) gives the cells' scores from their target letters and
    their flat query rows (qid * lq + query position)."""
    dev = cqid.device
    out = torch.zeros(cqid.shape[0], dtype=torch.int32, device=dev)
    if n_valid is not None:
        cvalid = cvalid & (torch.arange(cqid.shape[0], device=dev)
                           < n_valid.reshape(()))
    sel = torch.nonzero(cvalid).flatten()
    if sel.numel() == 0:
        return out
    qid = cqid[sel].long()
    tid = cid[sel].long()
    qs, ts, n = _window(qid, tid, cdiag[sel], t_len, q_len)
    res = torch.zeros(sel.numel(), dtype=torch.int64, device=dev)
    for lo in range(0, sel.numel(), PLAIN_ROWS):
        hi = min(lo + PLAIN_ROWS, sel.numel())
        n_k = n[lo:hi]
        ln = int(n_k.max())
        if ln == 0:
            continue
        l = torch.arange(ln, device=dev)[None, :]
        active = l < n_k[:, None]
        base = t_off[tid[lo:hi]] + ts[lo:hi]
        tc = t_cat[torch.where(active, base[:, None] + l, 0)].long()
        qrow = qid[lo:hi, None] * lq + torch.where(
            active, qs[lo:hi, None] + l, 0)
        s = torch.where(active, cell(tc, qrow), 0)
        cums = torch.cumsum(s, 1)
        prev_min = torch.cat(
            [torch.zeros_like(cums[:, :1]),
             torch.cummin(cums, 1).values[:, :-1]], 1).clamp(max=0)
        run = torch.where(active, cums - prev_min, 0)
        res[lo:hi] = run.max(1).values
    out[sel] = res.clamp(min=0).to(torch.int32)
    return out


def diag_rescore_plain(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad,
                       corr, submat, q_len, n_valid=None):
    """Plain version of diag_rescore: valid candidates are gathered in
    blocks of PLAIN_ROWS, each as wide as its longest window."""
    alpha = submat.shape[1]
    sub_flat = submat.reshape(-1).long()
    q_flat = q_pad.reshape(-1)
    corr_flat = corr.reshape(-1)
    return _plain(
        cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_len, n_valid,
        q_pad.shape[1],
        lambda tc, qrow: sub_flat[q_flat[qrow].long() * alpha + tc]
        + corr_flat[qrow])


def _launch_kernel(args, n_valid):
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, submat, \
        q_len = args
    dev = cqid.device
    n = cqid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.diag_rescore_launch(
            cqid.data_ptr(), cid.data_ptr(), cdiag.data_ptr(),
            cvalid.data_ptr(), None if n_valid is None else
            n_valid.data_ptr(), n, t_cat.data_ptr(), t_cat.numel(),
            t_off.data_ptr(), t_len.data_ptr(), q_pad.data_ptr(),
            corr.data_ptr(), q_pad.shape[0], q_pad.shape[1],
            q_len.data_ptr(), submat.data_ptr(), submat.shape[0],
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"diag_rescore kernel launch failed: CUDA error "
                           f"{err}")
    diag_rescore.launches += 1
    return out


def diag_rescore(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr,
                 submat, q_len, n_valid=None):
    """Exact best ungapped diagonal score per candidate, (C,) int32 on the
    inputs' device (see the module docstring for the tensors and the valid
    count)."""
    args = (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr,
            submat, q_len)
    _check(args, n_valid)
    dev = cqid.device
    if dev.type == "cpu":
        return diag_rescore_plain(*args, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"diag_rescore: no kernel for device {dev}")
    return _launch_kernel(args, n_valid)


diag_rescore.launches = 0


def profile_rows(rows):
    """int8 (L, PROFILE_WIDTH) rows of a query's integer (L, A) rescore
    profile (A <= PROFILE_WIDTH), zero past column A. Raises on a value
    that does not fit int8: the profile form never clamps."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] > PROFILE_WIDTH:
        raise ValueError(f"a rescore profile must be (L, A) with A <= "
                         f"{PROFILE_WIDTH}, got {rows.shape}")
    if rows.size and (rows.min() < -128 or rows.max() > 127):
        raise ValueError(f"rescore profile values {int(rows.min())}.."
                         f"{int(rows.max())} do not fit int8")
    out = np.zeros((rows.shape[0], PROFILE_WIDTH), np.int8)
    out[:, :rows.shape[1]] = rows
    return out


def diag_rescore_profile_plain(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len,
                               prof, q_len, n_valid=None):
    """Plain version of diag_rescore_profile (the JAX package's
    device_stages.make_rescore): blocks of PLAIN_ROWS candidates."""
    prof_flat = prof.reshape(-1)
    return _plain(
        cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_len, n_valid,
        prof.shape[1],
        lambda tc, qrow: prof_flat[qrow * PROFILE_WIDTH + tc].long())


def diag_rescore_profile(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof,
                         q_len, n_valid=None):
    """The profile form: exact best ungapped diagonal score per candidate
    with a cell's score read from its query's profile row, (C,) int32 on
    the inputs' device. prof is (B, Lq, 32) int8 (profile_rows); target
    letters must be < 32."""
    args = (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len)
    _check_profile(args, n_valid)
    dev = cqid.device
    if dev.type == "cpu":
        return diag_rescore_profile_plain(*args, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"diag_rescore_profile: no kernel for device {dev}")
    n = cqid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.diag_rescore_profile_launch(
            cqid.data_ptr(), cid.data_ptr(), cdiag.data_ptr(),
            cvalid.data_ptr(), None if n_valid is None else
            n_valid.data_ptr(), n, t_cat.data_ptr(), t_cat.numel(),
            t_off.data_ptr(), t_len.data_ptr(), prof.data_ptr(),
            prof.shape[0], prof.shape[1], q_len.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"diag_rescore_profile kernel launch failed: CUDA "
                           f"error {err}")
    diag_rescore_profile.launches += 1
    return out


diag_rescore_profile.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("rescore")
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.diag_rescore_launch.argtypes = [p, p, p, p, p, i, p, ll, p, p, p,
                                            p, i, i, p, p, i, p, p]
        lib.diag_rescore_launch.restype = ctypes.c_int
        lib.diag_rescore_profile_launch.argtypes = [
            p, p, p, p, p, i, p, ll, p, p, p, i, i, p, p, p]
        lib.diag_rescore_profile_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
