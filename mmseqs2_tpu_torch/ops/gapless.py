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
kernel launches.

Layout as in the JAX package: profile (32, Lq) int32 (pad rows and the pad
letter's row score -(1 << 20)), targets_t (Lt, B) int8 with pad letter 31.
Outputs are (B,) int32. The target end is the first column reaching the
score, the query end the smallest row attaining it in that column; a lane
with no positive cell gives (0, Lq - 1, -1).
"""

import ctypes

import torch

from . import dp

ALPHA_PAD = 32
MAX_STRIP = 32          # query rows per thread; a warp covers 32 * 32 rows


def gapless_plain(profile, targets_t, cap=255):
    """Plain version of gapless: dp.gapless_scan with one profile and one cap
    for every lane, end positions tracked."""
    nb = targets_t.shape[1]
    qidx = torch.zeros(nb, dtype=torch.int64, device=profile.device)
    caps = torch.full((nb,), int(cap), dtype=torch.int32,
                      device=profile.device)
    return dp.gapless_scan(profile[None], qidx, targets_t.T, caps,
                           with_endpos=True)


def gapless_score_plain(profile, targets_t, cap=255):
    """Plain version of gapless_score: the column scan without the per-step
    cap; the cap is applied once at the end, as the kernel does."""
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


def _launch_kernel(wrapper, profile, targets_t, cap, track):
    dev = profile.device
    for name, t, dtype in (("profile", profile, torch.int32),
                           ("targets_t", targets_t, torch.int8)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lq = profile.shape[1]
    lt, nb = targets_t.shape
    out = [torch.empty(nb, dtype=torch.int32, device=dev)
           for _ in range(3 if track else 1)]
    if nb == 0:
        return out
    strip = 1
    while strip < MAX_STRIP and 32 * strip < lq:
        strip *= 2
    hb = None
    if lq > 32 * strip:         # strip-mined long query: boundary scratch
        hb = torch.empty((nb, lt), dtype=torch.int32, device=dev)
    vec = int(lq % 4 == 0 and profile.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gapless_launch(
            profile.data_ptr(), lq, targets_t.data_ptr(), lt, nb, int(cap),
            int(track), vec, strip, out[0].data_ptr(),
            out[1].data_ptr() if track else None,
            out[2].data_ptr() if track else None,
            hb.data_ptr() if hb is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"gapless kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def _dispatch(wrapper, plain, profile, targets_t, cap, track):
    _check(wrapper.__name__, profile, targets_t)
    dev = profile.device
    if dev.type == "cpu":
        return plain(profile, targets_t, cap)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: no kernel for device {dev}")
    out = _launch_kernel(wrapper, profile, targets_t, cap, track)
    return tuple(out) if track else out[0]


def gapless(profile, targets_t, cap=255):
    """(score, qend, tend) of the best gapless diagonal segment per lane,
    with H held in [0, cap] at every step."""
    return _dispatch(gapless, gapless_plain, profile, targets_t, cap, True)


def gapless_score(profile, targets_t, cap=255):
    """Best gapless diagonal score per lane, min(score, cap)."""
    return _dispatch(gapless_score, gapless_score_plain, profile, targets_t,
                     cap, False)


gapless.launches = 0
gapless_score.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("gapless")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gapless_launch.argtypes = [p, i, p, i, i, i, i, i, i, p, p, p, p,
                                       p]
        lib.gapless_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
