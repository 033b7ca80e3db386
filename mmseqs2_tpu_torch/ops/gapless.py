"""Gapless (diagonal) scan of one query profile against many targets: the
exhaustive prefilter's device scan.

Port of the two gapless entry points of mmseqs2_tpu/ops/pallas_sw.py:

  gapless        `sw_pallas(gapless=True)`: (score, qend, tend), H clamped to
                 [0, cap] at every step, so the end is where the saturating
                 walk first reaches the score.
  gapless_score  `gapless_pallas_score`: the score alone; H is clamped at 0
                 only and the cap applied once to the result, which is the
                 same number (saturation commutes with the final max).

Each wrapper sends a CUDA tensor to the hand-written kernel (csrc/gapless.cu,
built at first use) and a CPU tensor to its plain version (`gapless_plain`,
`gapless_score_plain`); anything else raises. `<wrapper>.launches` counts
kernel launches, `<wrapper>.form_launches` the same by form.

Layout as in the JAX package: profile (32, Lq) int32 (pad rows and the pad
letter's row score -(1 << 20)), targets_t (Lt, B) int8 with pad letter 31.
Outputs are (B,) int32. The target end is the first column reaching the
score, the query end the smallest row attaining it in that column; a lane
with no positive cell gives (0, Lq - 1, -1), Lq being the profile's length.

Real lengths (optional): q_len, the profile's real rows (every entry of a
row >= q_len is <= -(1 << 20)), and t_lens, a (B,) int32 tensor on the
targets' device with each lane's real columns (columns >= t_lens[b] hold
letter 31, and the profile's row 31 is <= -(1 << 20) on the real rows).
Under that contract the cells past either length are 0 and the kernel skips
them with the same result; the plain versions check the contract, raise
ValueError where it does not hold, and scan everything.

The kernel has two forms, chosen by `pick_form` from cap and the profile's
largest entry: int16 (two rows per register, Hopper's DPX instructions)
wherever every sum fits in 16 bits, int32 otherwise. prof_max, when the
caller knows it, saves reading the maximum back from the card (a
synchronisation).
"""

import ctypes

import torch

from . import dp

ALPHA_PAD = 32
PAD_LETTER = 31
NEG = -(1 << 20)        # pad rows and the pad letter's row score at most this
INT16_LIMIT = 1 << 15
# rows per thread the kernel is built for; a warp covers 32 of these strips
# per chunk, and longer queries take several chunks
ROWS = {"int32": (1, 2, 4, 8, 12, 16, 20, 24, 28, 32),
        "int16": (2, 4, *range(8, 65, 4))}


def pick_form(cap, prof_max):
    """The kernel form for a call: "int16" when 0 <= cap and cap + the
    profile's largest entry < 32768 (then no H + s leaves the 16-bit range),
    else "int32"."""
    cap, prof_max = int(cap), int(prof_max)
    return "int16" if 0 <= cap and cap + prof_max < INT16_LIMIT else "int32"


def strip_plan(form, q_len):
    """(rows per thread, chunks) for q_len real query rows: the fewest
    chunks, then the smallest strip that covers them. A warp computes
    32 * rows * chunks rows per column."""
    choices = ROWS[form]
    n = max(int(q_len), 1)
    chunks = -(-n // (32 * choices[-1]))
    per = -(-n // (32 * chunks))
    return next(r for r in choices if r >= per), chunks


def rows_computed(form, q_len):
    """The query rows a warp computes per column for q_len real rows."""
    rows, chunks = strip_plan(form, q_len)
    return 32 * rows * chunks


def check_lengths(name, profile, targets_t, q_len, t_lens, prof_max=None):
    """Raise ValueError unless the lengths' contract holds (see the module
    docstring) and prof_max, when given, is at least the profile's largest
    entry."""
    lq = profile.shape[1]
    lt, nb = targets_t.shape
    if q_len is not None:
        if not 0 <= int(q_len) <= lq:
            raise ValueError(f"{name}: q_len {q_len} outside [0, {lq}]")
        if bool((profile[:, int(q_len):] > NEG).any()):
            raise ValueError(f"{name}: a profile row past q_len {q_len} is "
                             f"not pad (an entry above {NEG})")
    if t_lens is not None:
        if t_lens.shape != (nb,) or t_lens.device != targets_t.device:
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
        rows = lq if q_len is None else int(q_len)
        if bool((profile[PAD_LETTER, :rows] > NEG).any()):
            raise ValueError(f"{name}: the pad letter's profile row scores "
                             f"above {NEG} on a real row")
    if prof_max is not None and int(prof_max) < int(profile.max()):
        raise ValueError(f"{name}: prof_max {prof_max} below the profile's "
                         f"largest entry {int(profile.max())}")


def gapless_plain(profile, targets_t, cap=255, q_len=None, t_lens=None,
                  prof_max=None):
    """Plain version of gapless: dp.gapless_scan with one profile and one cap
    for every lane, end positions tracked, over every cell."""
    check_lengths("gapless_plain", profile, targets_t, q_len, t_lens,
                 prof_max)
    nb = targets_t.shape[1]
    qidx = torch.zeros(nb, dtype=torch.int64, device=profile.device)
    caps = torch.full((nb,), int(cap), dtype=torch.int32,
                      device=profile.device)
    return dp.gapless_scan(profile[None], qidx, targets_t.T, caps,
                           with_endpos=True)


def gapless_score_plain(profile, targets_t, cap=255, q_len=None, t_lens=None,
                        prof_max=None):
    """Plain version of gapless_score: the column scan without the per-step
    cap over every cell; the cap is applied once at the end."""
    check_lengths("gapless_score_plain", profile, targets_t, q_len, t_lens,
                 prof_max)
    dev = profile.device
    i32 = torch.int32
    prof = profile.to(i32)
    lq = prof.shape[1]
    lt, nb = targets_t.shape
    letters = targets_t.to(torch.int64)
    H = torch.zeros((nb, lq), dtype=i32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=i32, device=dev)
    best = torch.zeros(nb, dtype=i32, device=dev)
    for j in range(lt):
        H = (torch.cat([zero_col, H[:, :-1]], 1) + prof[letters[j]]) \
            .clamp_(min=0)
        best = torch.maximum(best, H.max(1).values)
    return best.clamp_(max=int(cap))


def _check(name, profile, targets_t):
    if profile.dim() != 2 or profile.shape[0] != ALPHA_PAD \
            or profile.shape[1] == 0:
        raise ValueError(f"{name}: profile must be ({ALPHA_PAD}, Lq) with "
                         f"Lq >= 1, got {tuple(profile.shape)}")
    if targets_t.dim() != 2:
        raise ValueError(f"{name}: targets_t must be (Lt, B), got "
                         f"{tuple(targets_t.shape)}")
    if targets_t.device != profile.device:
        raise ValueError(f"{name}: targets_t is on {targets_t.device}, "
                         f"profile on {profile.device}")


def _launch_kernel(wrapper, profile, targets_t, cap, track, q_len, t_lens,
                   prof_max):
    dev = profile.device
    tensors = [("profile", profile, torch.int32),
               ("targets_t", targets_t, torch.int8)]
    if t_lens is not None:
        tensors.append(("t_lens", t_lens, torch.int32))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lq = profile.shape[1]
    lt, nb = targets_t.shape
    if t_lens is not None and (t_lens.shape != (nb,)
                               or t_lens.device != dev):
        raise ValueError(f"t_lens must be ({nb},) on {dev}")
    q_len = lq if q_len is None else int(q_len)
    if not 0 <= q_len <= lq:
        raise ValueError(f"q_len {q_len} outside [0, {lq}]")
    out = [torch.empty(nb, dtype=torch.int32, device=dev)
           for _ in range(3 if track else 1)]
    if nb == 0:
        return out
    if prof_max is None:
        prof_max = int(profile.max())
    form = pick_form(cap, prof_max)
    rows, chunks = strip_plan(form, q_len)
    hb = None
    if chunks > 1:              # strip-mined long query: boundary scratch
        hb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
    n = rows // 2 if form == "int16" else rows     # words per thread
    packed = torch.empty((ALPHA_PAD, 32 * n * chunks), dtype=torch.int32,
                         device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gapless_launch(
            profile.data_ptr(), lq, targets_t.data_ptr(), lt, nb,
            t_lens.data_ptr() if t_lens is not None else None, int(cap),
            int(track), int(form == "int16"), rows, chunks,
            packed.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr() if track else None,
            out[2].data_ptr() if track else None,
            hb.data_ptr() if hb is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"gapless kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.form_launches[form] += 1
    return out


def _dispatch(wrapper, plain, profile, targets_t, cap, track, q_len, t_lens,
              prof_max):
    _check(wrapper.__name__, profile, targets_t)
    dev = profile.device
    if dev.type == "cpu":
        return plain(profile, targets_t, cap, q_len, t_lens, prof_max)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: no kernel for device {dev}")
    out = _launch_kernel(wrapper, profile, targets_t, cap, track, q_len,
                         t_lens, prof_max)
    return tuple(out) if track else out[0]


def gapless(profile, targets_t, cap=255, q_len=None, t_lens=None,
            prof_max=None):
    """(score, qend, tend) of the best gapless diagonal segment per lane,
    with H held in [0, cap] at every step."""
    return _dispatch(gapless, gapless_plain, profile, targets_t, cap, True,
                     q_len, t_lens, prof_max)


def gapless_score(profile, targets_t, cap=255, q_len=None, t_lens=None,
                  prof_max=None):
    """Best gapless diagonal score per lane, min(score, cap)."""
    return _dispatch(gapless_score, gapless_score_plain, profile, targets_t,
                     cap, False, q_len, t_lens, prof_max)


for _w in (gapless, gapless_score):
    _w.launches = 0
    _w.form_launches = {"int16": 0, "int32": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("gapless")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gapless_launch.argtypes = [p, i, p, i, i, p, i, i, i, i, i, p, p,
                                       p, p, p, p]
        lib.gapless_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
