"""Affine-gap Smith-Waterman scans: scores and end positions.

Port of the gapped entry points of mmseqs2_tpu/ops/pallas_sw.py. Every lane b
aligns the target in column b of `targets_t` against a query profile.

  sw_multi   `sw_pallas_multi`, the align stage's scan: lane b takes profile
             `qsel[b]` of NQ, confined to query rows >= `qoff[b]`.
  sw_single  `sw_pallas` (gapped): one (32, Lq) profile for every lane; the
             local gapped exhaustive prefilter's scan.
  sw_offset  `sw_pallas_offset`: one profile and a per-lane `qoff`.
  sw_score   `sw_pallas_score`: one profile, the score alone (the max of H
             over all cells), without end tracking; the resident server's
             gapped scan.

Each wrapper sends a CUDA tensor to the hand-written kernel template of
csrc/sw.cu (built at first use; sw_single is its case NQ = 1 without an
offset, sw_score that without end tracking) and a CPU tensor to its plain
version (`sw_multi_plain`, `sw_single_plain`, `sw_offset_plain`,
`sw_score_plain`: batched column scans with the kernel's exact semantics, on
any device); anything else raises. `<wrapper>.launches` counts that
wrapper's kernel launches, `<wrapper>.form_launches` the same by form.

Semantics (those of the TPU kernel): affine gaps, a gap of length k costs
go + (k-1)*ge with go >= ge; E reads the previous column's H after the lazy-F
correction; the score is the best H; the target end is the first column
reaching it and the query end the smallest row attaining it in that column.
A lane whose scores are all <= 0 gives (0, lq - 1, -1). The query end is in
full-profile coordinates (the caller subtracts qoff).

The row window (optional keywords; the plain versions check it, raise
ValueError where it does not hold, and scan every cell). Lane b's rows are
[qoff[b], end), end = q_lens[qsel[b]] (sw_multi: a (NQ,) int32 tensor on the
profiles' device) or q_len (the single-profile entry points: an int), Lq when
not given:
  - every entry of a profile's rows at or past its end is <= -(1 << 20);
  - t_lens, a (B,) int32 tensor on the targets' device, holds each lane's
    real columns: columns >= t_lens[b] hold letter 31, and the profile's
    row 31 is <= -(1 << 20) on the rows before its end;
  - prof_max, when given, is at least the profiles' largest entry;
  - max_window, when given, is at least the longest window, max over b of
    end - qoff[b] (an empty window, qoff[b] >= end, is allowed and gives
    (0, Lq - 1, -1)).
The aligner's reverse pass reads the reversed profile, whose pad rows come
first: its window is [qoff, Lq), end left at Lq. A cell past a length can
be above 0 (a gap runs into it), but it is below a real cell's H or equal to
one in an earlier column or a smaller row, and it feeds only cells past the
lengths, so the kernel skips them with the same result; the rows of a
window's first strip below qoff score as pad there. The kernel has two
forms, chosen by `pick_form` from the longest window and the profiles'
largest entry: int16 (two rows per register, Hopper's DPX instructions) and
int32. prof_max and max_window, when the caller knows them, save reading
them back from the card (a synchronisation).
"""

import ctypes

import numpy as np
import torch

from . import gapless

ALPHA_PAD = 32
PAD_LETTER = gapless.PAD_LETTER
NEG = gapless.NEG
NEG_INF = -(1 << 28)
INT16_LIMIT = 1 << 15


def pick_form(rows, prof_max, go, ge):
    """The form of the kernel for a launch: "int16" where every value the
    recurrence forms fits in 16 bits, else "int32". rows is the launch's
    longest window (a lane's rows [qoff, end); q_len for one profile
    without an offset). The kernel keeps E' = E + go, F' = F + go (clamped
    at 0, which is exact) and H, all in [0, score]; the bounds, for the
    profiles' largest entry prof_max and gaps go >= ge >= 0:
      - the score: at most rows * max(prof_max, 0) < 32768 (a lane aligns
        each row of its window once), so no H, E' or F' overflows (a real
        entry is at most the score);
      - H + s: H >= 0 and s >= -32768 (entries saturate there: pad rows,
        rows below qoff and the pad letter score <= -(1 << 20), so a
        saturated sum stays below 0 and loses to the 0 of the local
        alignment);
      - E and F: E' - go, F' - go, E' - ge and F' - ge are at least -go
        after the first column (E >= -go), so go < 32768;
      - the prefix-max F: its ramp i * ge is taken relative to the chunk's
        first row, so it stays below 32 * strip rows * ge, and it is formed
        in the warp scan's int32, one word per strip, as is the F' a
        strip-mined window hands the next chunk (gb, clamped at 0): what
        comes back into 16 bits is an F' in [0, score]. So it needs no
        16-bit bound.
    With BLOSUM62 at 2 bits (largest entry 11) and a bias that does not
    raise it, windows up to 2,978 rows take int16."""
    rows, prof_max, go, ge = int(rows), int(prof_max), int(go), int(ge)
    score = rows * max(prof_max, 0)
    fits = score < INT16_LIMIT and 0 <= ge <= go < INT16_LIMIT
    return "int16" if fits else "int32"


def rows_computed(form, max_window, q_end, qoff=0):
    """Rows the kernel computes per column for each lane, as a numpy array:
    at the strip plan (ops/gapless.py:strip_plan) of the launch's longest
    window, each lane's window [qoff, q_end) from the strip holding qoff
    (qoff rounded down to the strip height), in chunks of 32 strips; 0 for
    an empty window."""
    rows, _ = gapless.strip_plan(form, max_window)
    q_end = np.asarray(q_end, np.int64)
    qoff = np.maximum(np.asarray(qoff, np.int64), 0)
    base = qoff // rows * rows
    chunk = 32 * rows
    return np.where(q_end > qoff, -(-(q_end - base) // chunk), 0) * chunk


def check_contract(name, prof_flat, targets_t, qsel=None, qoff=None,
                   q_lens=None, t_lens=None, prof_max=None, max_window=None):
    """Raise ValueError unless the row window's contract (the module
    docstring) holds for these inputs."""
    nq = prof_flat.shape[0] // ALPHA_PAD
    lq = prof_flat.shape[1]
    lt, nb = targets_t.shape
    prof = prof_flat.reshape(nq, ALPHA_PAD, lq)
    rows = torch.arange(lq, device=prof_flat.device)
    ends = torch.full((nq,), lq, dtype=torch.int64, device=prof_flat.device)
    if qsel is not None and bool(((qsel < 0) | (qsel >= nq)).any()):
        raise ValueError(f"{name}: qsel outside [0, {nq})")
    if q_lens is not None:
        if tuple(q_lens.shape) != (nq,) or q_lens.device != prof_flat.device:
            raise ValueError(f"{name}: q_lens must be ({nq},) on "
                             f"{prof_flat.device}, got "
                             f"{tuple(q_lens.shape)} on {q_lens.device}")
        if bool(((q_lens < 0) | (q_lens > lq)).any()):
            raise ValueError(f"{name}: q_lens outside [0, {lq}]")
        ends = q_lens.to(torch.int64)
        past = rows[None, :] >= ends[:, None]
        if bool(((prof > NEG).any(1) & past).any()):
            raise ValueError(f"{name}: a profile row past its q_lens is not "
                             f"pad (an entry above {NEG})")
    if t_lens is not None:
        if tuple(t_lens.shape) != (nb,) or t_lens.device != targets_t.device:
            raise ValueError(f"{name}: t_lens must be ({nb},) on "
                             f"{targets_t.device}, got "
                             f"{tuple(t_lens.shape)} on {t_lens.device}")
        if bool(((t_lens < 0) | (t_lens > lt)).any()):
            raise ValueError(f"{name}: t_lens outside [0, {lt}]")
        past = torch.arange(lt, device=t_lens.device)[:, None] \
            >= t_lens[None, :].to(torch.int64)
        if bool((targets_t[past] != PAD_LETTER).any()):
            raise ValueError(f"{name}: a real letter past t_lens (only "
                             f"{PAD_LETTER} may follow a target)")
        real = rows[None, :] < ends[:, None]
        if bool(((prof[:, PAD_LETTER] > NEG) & real).any()):
            raise ValueError(f"{name}: the pad letter's profile row scores "
                             f"above {NEG} on a real row")
    if prof_max is not None and int(prof_max) < int(prof_flat.max()):
        raise ValueError(f"{name}: prof_max {prof_max} below the profiles' "
                         f"largest entry {int(prof_flat.max())}")
    if max_window is not None and nb:
        longest = _longest_window(ends, qsel, qoff)
        if int(max_window) < longest:
            raise ValueError(f"{name}: max_window {max_window} below the "
                             f"longest window, {longest} rows")


def _longest_window(ends, qsel, qoff):
    """max over lanes of end[qsel[b]] - qoff[b], at least 0 (a read-back)."""
    end = ends[qsel.to(torch.int64)] if qsel is not None else ends[:1]
    if qoff is not None:
        end = end.to(qoff.device) - qoff.to(torch.int64).clamp(min=0)
    return max(int(end.max()), 0) if end.numel() else 0


def _q_lens(q_len, device):
    """A single profile's q_len as the (1,) tensor of q_lens, or None."""
    if q_len is None:
        return None
    return torch.tensor([int(q_len)], dtype=torch.int32, device=device)


def sw_multi_plain(prof_flat, targets_t, qsel, qoff=None, go=11, ge=1, *,
                   q_lens=None, t_lens=None, prof_max=None, max_window=None):
    """Plain version of sw_multi: checks the row window's contract, then
    scans every cell, column by column over the target axis.

    prof_flat: (NQ*32, Lq) int32, query q's substitution rows at
    [q*32, (q+1)*32); targets_t: (Lt, B) integer letters in [0, 32);
    qsel, qoff: (B,) int32 (None: profile 0, offset 0). Returns (score,
    qend, tend), each (B,) int32."""
    check_contract("sw_multi_plain", prof_flat, targets_t, qsel, qoff, q_lens,
                   t_lens, prof_max, max_window)
    dev = prof_flat.device
    i32 = torch.int32
    lq = prof_flat.shape[1]
    lt, nb = targets_t.shape
    if qsel is None:
        qsel = torch.zeros(nb, dtype=i32, device=dev)
    if qoff is None:
        qoff = torch.zeros(nb, dtype=i32, device=dev)
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


def sw_single_plain(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
                    prof_max=None):
    """Plain version of sw_single: sw_multi_plain at NQ = 1 without an
    offset, its window [0, q_len)."""
    return sw_multi_plain(profile, targets_t, None, None, go, ge,
                          q_lens=_q_lens(q_len, profile.device),
                          t_lens=t_lens, prof_max=prof_max)


def sw_offset_plain(profile, targets_t, qoff, go=11, ge=1, *, q_len=None,
                    t_lens=None, prof_max=None, max_window=None):
    """Plain version of sw_offset: sw_multi_plain at NQ = 1."""
    return sw_multi_plain(profile, targets_t, None, qoff, go, ge,
                          q_lens=_q_lens(q_len, profile.device),
                          t_lens=t_lens, prof_max=prof_max,
                          max_window=max_window)


def sw_score_plain(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
                   prof_max=None):
    """Plain version of sw_score: the best H of the tracked scan."""
    return sw_single_plain(profile, targets_t, go, ge, q_len, t_lens,
                           prof_max)[0]


def _check_tensors(dev, **tensors):
    """Raise unless every (tensor, dtype) given (None skipped) lies on dev,
    has that dtype and is contiguous, as a kernel reads it."""
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(wrapper, prof_flat, targets_t, qsel, qoff, go, ge, track=True,
            q_len=None, q_lens=None, t_lens=None, prof_max=None,
            max_window=None):
    """Launch the kernel for `wrapper` (whose counts it raises) in the form
    pick_form chooses; track False gives the score alone. q_len (an int)
    ends every window when q_lens is None."""
    dev = prof_flat.device
    _check_tensors(dev, prof_flat=(prof_flat, torch.int32),
                   targets_t=(targets_t, torch.int8),
                   qsel=(qsel, torch.int32), qoff=(qoff, torch.int32),
                   q_lens=(q_lens, torch.int32),
                   t_lens=(t_lens, torch.int32))
    nqa, lq = prof_flat.shape
    nq = nqa // ALPHA_PAD
    lt, nb = targets_t.shape
    if t_lens is not None and t_lens.shape != (nb,):
        raise ValueError(f"t_lens must be ({nb},), got {tuple(t_lens.shape)}")
    if q_lens is not None and q_lens.shape != (nq,):
        raise ValueError(f"q_lens must be ({nq},), got {tuple(q_lens.shape)}")
    q_len = lq if q_len is None else int(q_len)
    if not 0 <= q_len <= lq:
        raise ValueError(f"q_len {q_len} outside [0, {lq}]")
    out = [torch.empty(nb, dtype=torch.int32, device=dev)
           for _ in range(3 if track else 1)]
    if nb == 0:
        return tuple(out)
    if prof_max is None:
        prof_max = int(prof_flat.max())
    if max_window is None:
        if q_lens is None and qoff is None:
            max_window = q_len
        else:
            ends = (q_lens.to(torch.int64) if q_lens is not None else
                    torch.full((nq,), q_len, dtype=torch.int64, device=dev))
            max_window = _longest_window(ends, qsel, qoff)
    form = pick_form(max_window, prof_max, go, ge)
    rows, _ = gapless.strip_plan(form, max_window)
    hb = gb = None
    # a window runs from the strip holding qoff: up to rows - 1 more rows
    if int(max_window) + (rows - 1 if qoff is not None else 0) > 32 * rows:
        hb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
        gb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
    n = rows // 2 if form == "int16" else rows     # words per thread
    nstrips = -(-lq // rows) + 1                   # the last one all pad
    packed = torch.empty(nq * ALPHA_PAD * n * nstrips, dtype=torch.int32,
                         device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_launch(
            prof_flat.data_ptr(), nq, lq, q_len, ptr(q_lens), ptr(qsel),
            ptr(qoff), targets_t.data_ptr(), lt, nb, ptr(t_lens), int(go),
            int(ge), int(track), int(form == "int16"), rows, nstrips,
            packed.data_ptr(), out[0].data_ptr(),
            ptr(out[1] if track else None), ptr(out[2] if track else None),
            ptr(hb), ptr(gb), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    wrapper.launches += 1
    wrapper.form_launches[form] += 1
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


def sw_multi(prof_flat, targets_t, qsel, qoff=None, go=11, ge=1, *,
             q_lens=None, t_lens=None, prof_max=None, max_window=None):
    """Scores and end positions of many (query profile, target) lanes.

    Same arguments and layout as mmseqs2_tpu's sw_pallas_multi, as torch
    tensors: prof_flat (NQ*32, Lq) int32, targets_t (Lt, B) int8 (pad letter
    31), qsel and qoff (B,) int32 (qoff None means 0). Profile scores must
    lie within +-(1 << 20). q_lens, t_lens, prof_max and max_window as in
    the module docstring. Returns (score, qend, tend) (B,) int32 on the
    inputs' device."""
    _check(prof_flat, targets_t, qsel, qoff, go, ge)
    kw = dict(q_lens=q_lens, t_lens=t_lens, prof_max=prof_max,
              max_window=max_window)
    if _on_cpu("sw_multi", prof_flat, targets_t, qsel, qoff, q_lens, t_lens):
        return sw_multi_plain(prof_flat, targets_t, qsel, qoff, go, ge, **kw)
    return _launch(sw_multi, prof_flat, targets_t, qsel, qoff, go, ge, **kw)


def _check_single(profile, targets_t, qoff, go, ge):
    if profile.dim() != 2 or profile.shape[0] != ALPHA_PAD:
        raise ValueError(f"profile must be ({ALPHA_PAD}, Lq), got "
                         f"{tuple(profile.shape)}")
    _check(profile, targets_t, None, qoff, go, ge)


def sw_single(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
              prof_max=None):
    """(score, qend, tend) of one (32, Lq) profile against every lane of
    targets_t (Lt, B): mmseqs2_tpu's gapped sw_pallas. q_len, t_lens and
    prof_max as in the module docstring."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_single", profile, targets_t, t_lens):
        return sw_single_plain(profile, targets_t, go, ge, q_len, t_lens,
                               prof_max)
    return _launch(sw_single, profile, targets_t, None, None, go, ge,
                   q_len=q_len, t_lens=t_lens, prof_max=prof_max)


def sw_offset(profile, targets_t, qoff, go=11, ge=1, *, q_len=None,
              t_lens=None, prof_max=None, max_window=None):
    """sw_single with lane b confined to query rows >= qoff[b]
    (mmseqs2_tpu's sw_pallas_offset); qend in full-profile coordinates.
    q_len, t_lens, prof_max and max_window as in the module docstring."""
    _check_single(profile, targets_t, qoff, go, ge)
    kw = dict(q_len=q_len, t_lens=t_lens, prof_max=prof_max,
              max_window=max_window)
    if _on_cpu("sw_offset", profile, targets_t, qoff, t_lens):
        return sw_offset_plain(profile, targets_t, qoff, go, ge, **kw)
    return _launch(sw_offset, profile, targets_t, None, qoff, go, ge, **kw)


def sw_score(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
             prof_max=None):
    """Scores alone, (B,) int32, without end tracking (mmseqs2_tpu's
    sw_pallas_score); the arguments of sw_single."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_score", profile, targets_t, t_lens):
        return sw_score_plain(profile, targets_t, go, ge, q_len, t_lens,
                              prof_max)
    return _launch(sw_score, profile, targets_t, None, None, go, ge,
                   track=False, q_len=q_len, t_lens=t_lens,
                   prof_max=prof_max)[0]


for _w in (sw_multi, sw_single, sw_offset, sw_score):
    _w.launches = 0
    _w.form_launches = {"int16": 0, "int32": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("sw")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_launch.argtypes = [p, i, i, i, p, p, p, p, i, i, p, i, i, i, i,
                                  i, i, p, p, p, p, p, p, p]
        lib.sw_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
