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

Each wrapper sends a CUDA tensor to a hand-written kernel of csrc/sw.cu
(built at first use) and a CPU tensor to its plain version (`sw_multi_plain`,
`sw_single_plain`, `sw_offset_plain`, `sw_score_plain`: batched column scans
with the kernels' exact semantics, on any device); anything else raises.
sw_multi and sw_offset run `sw_multi_kernel`; sw_single and sw_score run
`sw_single_kernel`. `<wrapper>.launches` counts that wrapper's kernel
launches, `form_launches` (sw_single, sw_score) the same by form.

Semantics (those of the TPU kernel): affine gaps, a gap of length k costs
go + (k-1)*ge with go >= ge; E reads the previous column's H after the lazy-F
correction; the score is the best H; the target end is the first column
reaching it and the query end the smallest row attaining it in that column.
A lane whose scores are all <= 0 gives (0, lq - 1, -1). The query end is in
full-profile coordinates (the caller subtracts qoff).

sw_single and sw_score take the real lengths of ops/gapless.py (optional):
q_len, the profile's real rows (every entry of a row >= q_len is
<= -(1 << 20)), and t_lens, a (B,) int32 tensor on the targets' device with
each lane's real columns (columns >= t_lens[b] hold letter 31, and the
profile's row 31 is <= -(1 << 20) on the real rows). A cell past a length
can be above 0 (a gap runs into it), but it is below a real cell's H or
equal to one in an earlier column or a smaller row, and it feeds only cells
past the lengths, so the kernel skips them with the same result. The plain
versions check the contract, raise ValueError where it does not hold, and
scan every cell. The kernel has two forms, chosen by `pick_form` from the
input's range: int16 (two rows per register, Hopper's DPX instructions) and
int32. prof_max, when the caller knows it, saves reading the profile's
maximum back from the card (a synchronisation).
"""

import ctypes

import torch

from . import gapless

ALPHA_PAD = 32
NEG_INF = -(1 << 28)
MAX_STRIP = 32          # sw_multi: query rows per thread (32 * 32 a warp)
INT16_LIMIT = 1 << 15


def pick_form(q_len, prof_max, go, ge):
    """The form of sw_single_kernel for a call: "int16" where every value
    the recurrence forms fits in 16 bits, else "int32". The kernel keeps
    E' = E + go, F' = F + go (clamped at 0, which is exact) and H, all in
    [0, score]; the bounds, for q_len real rows, the profile's largest
    entry prof_max and gaps go >= ge >= 0:
      - the score: at most q_len * max(prof_max, 0) < 32768, so no H, E'
        or F' overflows (a real entry is at most the score);
      - H + s: H >= 0 and s >= -32768 (entries saturate there: pad rows
        and the pad letter score <= -(1 << 20), so a saturated sum stays
        below 0 and loses to the 0 of the local alignment);
      - E and F: E' - go, F' - go, E' - ge and F' - ge are at least -go
        after the first column (E >= -go), so go < 32768;
      - the prefix-max F: its ramp i * ge is taken relative to the chunk's
        first row, so it stays below 32 * rows * ge, and it is formed in the
        warp scan's int32, one word per strip, as is the F' a strip-mined
        query hands the next chunk (gb, clamped at 0): what comes back into
        16 bits is an F' in [0, score]. So it needs no 16-bit bound.
    With BLOSUM62 at 2 bits (largest entry 11) and a bias that does not
    raise it, queries up to 2,978 residues take int16."""
    q_len, prof_max, go, ge = int(q_len), int(prof_max), int(go), int(ge)
    score = q_len * max(prof_max, 0)
    fits = score < INT16_LIMIT and 0 <= ge <= go < INT16_LIMIT
    return "int16" if fits else "int32"


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


def sw_single_plain(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
                    prof_max=None):
    """Plain version of sw_single: checks the lengths' contract, then
    sw_multi_plain at NQ = 1, qoff = 0 over every cell."""
    gapless.check_lengths("sw_single_plain", profile, targets_t, q_len,
                          t_lens, prof_max)
    zeros = torch.zeros(targets_t.shape[1], dtype=torch.int32,
                        device=profile.device)
    return sw_multi_plain(profile, targets_t, zeros, zeros, go, ge)


def sw_offset_plain(profile, targets_t, qoff, go=11, ge=1):
    """Plain version of sw_offset: sw_multi_plain at NQ = 1."""
    return sw_multi_plain(profile, targets_t, torch.zeros_like(qoff), qoff,
                          go, ge)


def sw_score_plain(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
                   prof_max=None):
    """Plain version of sw_score: the best H of the tracked scan."""
    gapless.check_lengths("sw_score_plain", profile, targets_t, q_len, t_lens,
                          prof_max)
    return sw_single_plain(profile, targets_t, go, ge)[0]


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


def _launch_kernel(wrapper, prof_flat, targets_t, qsel, qoff, go, ge):
    """Launch sw_multi_kernel for `wrapper` (whose count it raises). qsel
    None means profile 0 for every lane."""
    dev = prof_flat.device
    _check_tensors(dev, prof_flat=(prof_flat, torch.int32),
                   targets_t=(targets_t, torch.int8),
                   qsel=(qsel, torch.int32), qoff=(qoff, torch.int32))
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

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_multi_launch(
            prof_flat.data_ptr(), nqa // ALPHA_PAD, lq, targets_t.data_ptr(),
            lt, nb, ptr(qsel), ptr(qoff), int(go), int(ge), vec, strip,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), ptr(hb),
            ptr(gb), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    wrapper.launches += 1
    return tuple(out)


def _launch_single(wrapper, profile, targets_t, go, ge, track, q_len, t_lens,
                   prof_max):
    """Launch sw_single_kernel for `wrapper` (whose counts it raises) in the
    form pick_form chooses; track False gives the score alone."""
    dev = profile.device
    _check_tensors(dev, profile=(profile, torch.int32),
                   targets_t=(targets_t, torch.int8),
                   t_lens=(t_lens, torch.int32))
    lq = profile.shape[1]
    lt, nb = targets_t.shape
    if t_lens is not None and t_lens.shape != (nb,):
        raise ValueError(f"t_lens must be ({nb},), got {tuple(t_lens.shape)}")
    q_len = lq if q_len is None else int(q_len)
    if not 0 <= q_len <= lq:
        raise ValueError(f"q_len {q_len} outside [0, {lq}]")
    out = [torch.empty(nb, dtype=torch.int32, device=dev)
           for _ in range(3 if track else 1)]
    if nb == 0:
        return tuple(out)
    if prof_max is None:
        prof_max = int(profile.max())
    form = pick_form(q_len, prof_max, go, ge)
    rows, chunks = gapless.strip_plan(form, q_len)
    hb = gb = None
    if chunks > 1:              # strip-mined long query: boundary scratch
        hb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
        gb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
    n = rows // 2 if form == "int16" else rows     # words per thread
    packed = torch.empty((ALPHA_PAD, 32 * n * chunks), dtype=torch.int32,
                         device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_single_launch(
            profile.data_ptr(), lq, targets_t.data_ptr(), lt, nb, ptr(t_lens),
            int(go), int(ge), int(track), int(form == "int16"), rows, chunks,
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


def sw_single(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
              prof_max=None):
    """(score, qend, tend) of one (32, Lq) profile against every lane of
    targets_t (Lt, B): mmseqs2_tpu's gapped sw_pallas. q_len, t_lens and
    prof_max as in the module docstring."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_single", profile, targets_t, t_lens):
        return sw_single_plain(profile, targets_t, go, ge, q_len, t_lens,
                               prof_max)
    return _launch_single(sw_single, profile, targets_t, go, ge, True, q_len,
                          t_lens, prof_max)


def sw_offset(profile, targets_t, qoff, go=11, ge=1):
    """sw_single with lane b confined to query rows >= qoff[b]
    (mmseqs2_tpu's sw_pallas_offset); qend in full-profile coordinates."""
    _check_single(profile, targets_t, qoff, go, ge)
    if _on_cpu("sw_offset", profile, targets_t, qoff):
        return sw_offset_plain(profile, targets_t, qoff, go, ge)
    return _launch_kernel(sw_offset, profile, targets_t, None, qoff, go, ge)


def sw_score(profile, targets_t, go=11, ge=1, q_len=None, t_lens=None,
             prof_max=None):
    """Scores alone, (B,) int32, without end tracking (mmseqs2_tpu's
    sw_pallas_score); the arguments of sw_single."""
    _check_single(profile, targets_t, None, go, ge)
    if _on_cpu("sw_score", profile, targets_t, t_lens):
        return sw_score_plain(profile, targets_t, go, ge, q_len, t_lens,
                              prof_max)
    return _launch_single(sw_score, profile, targets_t, go, ge, False, q_len,
                          t_lens, prof_max)[0]


for _w in (sw_multi, sw_single, sw_offset, sw_score):
    _w.launches = 0
for _w in (sw_single, sw_score):
    _w.form_launches = {"int16": 0, "int32": 0}

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
        lib.sw_single_launch.argtypes = [p, i, p, i, i, p, i, i, i, i, i, i,
                                         p, p, p, p, p, p, p]
        lib.sw_single_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
