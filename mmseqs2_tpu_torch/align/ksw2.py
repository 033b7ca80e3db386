"""Banded affine-gap extension alignment with Z-drop (ksw2-extz semantics).

The reference's nucleotide aligner delegates gapped extension to
ksw_extz2_sse (reference lib/ksw2/ksw2_extz2_sse.cpp, MIT; also
minimap2). For byte parity we reproduce that algorithm's exact observable
behavior, including its banding quirks:

  - anti-diagonal difference DP (u = H(r,t)-H(r-1,t), v = H(r,t)-H(r,t-1),
    x/y the gap-state differences), score offsets by 2*(q+e) with the
    max-cap at mat[0] + 2*(q+e);
  - per-row band [st0, en0] widened to 16-aligned [st, en]; cells in the
    rounded margin are updated with stale substitution scores and their
    direction bytes are reachable by the backtrack (faithful to the SSE
    implementation, NOT an idealized DP);
  - the 32-bit H row update with its lane-structured max scan (4-lane
    running max, lane-major tie resolution, en0 seeded first);
  - ksw_apply_zdrop's max/Z-drop bookkeeping and ksw_backtrack's state
    machine with left-aligned gaps.

This is the exact-score path (no KSW_EZ_APPROX_MAX), flags limited to
SCORE_ONLY/EXTZ_ONLY as used by BandedNucleotideAligner.

Port of mmseqs2_tpu/align/ksw2.py: `extz2` is the per-pair numpy oracle;
`extz2_batch` runs every batch through the native core
(native/ksw2_batch.cpp, OpenMP over pairs), built with the host's C++
compiler into the port's build directory at first use. There is no numpy
fallback: a missing compiler or a failed build raises with the compiler's
output.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR, REPO_ROOT

KSW_NEG_INF = -0x40000000

SCORE_ONLY = 0x01
EXTZ_ONLY = 0x40


class ExtzResult:
    __slots__ = ("max", "max_q", "max_t", "mqe", "mqe_t", "mte", "mte_q",
                 "score", "zdropped", "cigar")

    def __init__(self):
        self.max = 0
        self.max_q = self.max_t = self.mqe_t = self.mte_q = -1
        self.score = self.mqe = self.mte = KSW_NEG_INF
        self.zdropped = 0
        self.cigar = []          # list of (op, length); op 0=M 1=I 2=D


def _apply_zdrop(ez, H, r, t, zdrop, e):
    """ksw_apply_zdrop (ksw2.h:186), is_rot variant."""
    if H > ez.max:
        ez.max = H
        ez.max_t = t
        ez.max_q = r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = tl - ql if tl > ql else ql - tl
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = 1
            return True
    return False


def _push_cigar(cigar, op, length):
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + length)
    else:
        cigar.append((op, length))


def _backtrack(p_rows, off, off_end, i0, j0):
    """ksw_backtrack (ksw2.h:145), is_rot=1, is_rev=0, with_N=0.

    p_rows[r] is the direction byte array for row r covering
    [off[r], off_end[r]]; i = target index, j = query index.
    """
    cigar = []
    i, j = i0, j0
    state = 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if i > off_end[r]:
            force_state = 1
        tmp = int(p_rows[r][i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            _push_cigar(cigar, 0, 1)
            i -= 1
            j -= 1
        elif state == 1 or state == 3:
            _push_cigar(cigar, 2, 1)
            i -= 1
        else:
            _push_cigar(cigar, 1, 1)
            j -= 1
    if i >= 0:
        _push_cigar(cigar, 2, i + 1)
    if j >= 0:
        _push_cigar(cigar, 1, j + 1)
    cigar.reverse()
    return cigar


def extz2(query, target, mat, m, q, e, w, zdrop, flag):
    """Port of ksw_extz2_sse. query/target: int arrays (residue numbers),
    mat: flat m*m int list, q/e gap open/extend, w band, zdrop Z-drop."""
    ez = ExtzResult()
    qlen = len(query)
    tlen = len(target)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    with_cigar = not (flag & SCORE_ONLY)
    qe = q + e
    qe2 = 2 * qe
    sc_mch = int(mat[0])
    sc_mis = int(mat[1])
    max_cap = sc_mch + qe2
    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_16 = (tlen + 15) // 16 * 16
    qlen_16 = (qlen + 15) // 16 * 16

    min_sc = min(int(v) for v in mat)
    if -min_sc > 2 * qe:
        return ez

    # buffers (kcalloc zero-init, incl. the 16-byte padding regions)
    u = np.zeros(tlen_16, dtype=np.int64)
    v = np.zeros(tlen_16, dtype=np.int64)
    x = np.zeros(tlen_16, dtype=np.int64)
    y = np.zeros(tlen_16, dtype=np.int64)
    # s/sf get 16 slack cells: the reference's 16-wide score stores can run
    # past tlen_16 (into adjacent buffers); we give them scratch space
    s = np.zeros(tlen_16 + 16, dtype=np.int64)
    sf = np.zeros(tlen_16 + 16, dtype=np.int64)
    sf[:tlen] = np.asarray(target, dtype=np.int64)
    qr = np.zeros(qlen_16 + 16, dtype=np.int64)    # reversed query, 0-padded
    qr[:qlen] = np.asarray(query, dtype=np.int64)[::-1]
    H = np.full(tlen_16, KSW_NEG_INF, dtype=np.int64)

    p_rows = [None] * (qlen + tlen - 1) if with_cigar else None
    off = np.zeros(qlen + tlen - 1, dtype=np.int64)
    off_end = np.zeros(qlen + tlen - 1, dtype=np.int64)

    last_st = last_en = -1
    mat_arr = np.asarray(mat, dtype=np.int64).reshape(m, m)

    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        st = max(st, (r - wr + 1) >> 1)       # arithmetic shift = floor
        en = min(en, (r + wl) >> 1)
        if st > en:
            ez.zdropped = 1
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1 = int(x[st - 1])
                v1 = int(v[st - 1])
            else:
                x1 = v1 = 0
        else:
            x1 = 0
            v1 = q if r else 0
        if en >= r:
            y[r] = 0
            u[r] = q if r else 0
        # substitution scores for [st0 .. st0-aligned 16-block covering en0];
        # cells in [st, st0) keep stale values (loop fission starts at st0)
        s_hi = st0 + ((en0 - st0) // 16 + 1) * 16
        trange = np.arange(st0, s_hi)
        qchars = qr[(qlen - 1 - r) + trange]
        tchars = sf[trange]
        wild = (qchars == m - 1) | (tchars == m - 1)
        s[st0:s_hi] = np.where(wild, 0,
                               np.where(qchars == tchars, sc_mch, sc_mis))
        # core loop over the 16-rounded [st, en]
        n = en - st + 1
        xt1 = np.concatenate(([x1], x[st:en]))
        vt1 = np.concatenate(([v1], v[st:en]))
        zv = s[st:en + 1] + qe2
        a = xt1 + vt1
        b = y[st:en + 1] + u[st:en + 1]
        if with_cigar:
            d = (a > zv).astype(np.int64)             # 1 if a wins
            zv = np.maximum(zv, a)
            d = np.where(b > zv, 2, d)
        else:
            zv = np.maximum(zv, a)
        zv = np.maximum(zv, b)
        zv = np.minimum(zv, max_cap)
        ut_old = u[st:en + 1].copy()
        u[st:en + 1] = zv - vt1
        v[st:en + 1] = zv - ut_old
        zq = zv - q
        a = a - zq
        b = b - zq
        if with_cigar:
            amask = a > 0
            x[st:en + 1] = np.where(amask, a, 0)
            d |= np.where(amask, 0x08, 0)
            bmask = b > 0
            y[st:en + 1] = np.where(bmask, b, 0)
            d |= np.where(bmask, 0x10, 0)
            p_rows[r] = d
            off[r] = st
            off_end[r] = en
        else:
            x[st:en + 1] = np.maximum(a, 0)
            y[st:en + 1] = np.maximum(b, 0)

        # exact 32-bit H row + max scan (lane-structured tie-breaks)
        if r > 0:
            if en0 > 0:
                H[en0] = H[en0 - 1] + u[en0] - qe
            else:
                H[en0] = H[en0] + v[en0] - qe
            max_H = int(H[en0])
            max_t = en0
            en1 = st0 + (en0 - st0) // 4 * 4
            if en1 > st0:
                tr = np.arange(st0, en1)
                H[st0:en1] += v[st0:en1] - qe
                hb = H[st0:en1].reshape(-1, 4)
                lanes_max = np.full(4, max_H, dtype=np.int64)
                lanes_t = np.full(4, max_t, dtype=np.int64)
                base = tr.reshape(-1, 4)[:, 0]
                for lane in range(4):
                    col = hb[:, lane]
                    better = col > lanes_max[lane]
                    if better.any():
                        # running strict max keeps the FIRST achieving row
                        runmax = np.maximum.accumulate(col)
                        mx = int(runmax[-1])
                        if mx > lanes_max[lane]:
                            first = int(np.argmax(col == mx))
                            lanes_max[lane] = mx
                            lanes_t[lane] = base[first]
                for i_ in range(4):
                    if max_H < lanes_max[i_]:
                        max_H = int(lanes_max[i_])
                        max_t = int(lanes_t[i_]) + i_
            for t in range(en1, en0):
                H[t] += v[t] - qe
                if H[t] > max_H:
                    max_H = int(H[t])
                    max_t = t
        else:
            H[0] = v[0] - qe - qe
            max_H = int(H[0])
            max_t = 0
        # update ez
        if en0 == tlen - 1 and H[en0] > ez.mte:
            ez.mte = int(H[en0])
            ez.mte_q = r - en
        if r - st0 == qlen - 1 and H[st0] > ez.mqe:
            ez.mqe = int(H[st0])
            ez.mqe_t = st0
        if _apply_zdrop(ez, max_H, r, max_t, zdrop, e):
            break
        if r == qlen + tlen - 2 and en0 == tlen - 1:
            ez.score = int(H[tlen - 1])
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped and not (flag & EXTZ_ONLY):
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q)
    return ez


# ---------------------------------------------------------------------------
# batched extz2: the native core runs the oracle's arithmetic, one pair per
# OpenMP task; tests/test_torch_nucl.py holds it to `extz2` field by field
# ---------------------------------------------------------------------------

SOURCE = REPO_ROOT / "native" / "ksw2_batch.cpp"
CXXFLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    """The library's path in the build directory, keyed by the source and
    the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"ksw2_batch_{h.hexdigest()[:16]}.so"


def _build(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: concurrent processes never load
    # a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for cxx in ("g++", "c++", "clang++"):
        try:
            r = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cxx}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, so)
            return
        errors.append(f"{cxx}: {r.stderr.strip()}")
    raise RuntimeError("cannot build native/ksw2_batch.cpp, the banded "
                       "nucleotide aligner's batch core:\n"
                       + "\n".join(errors))


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
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.extz2_batch_c.restype = ctypes.c_int
            lib.extz2_batch_c.argtypes = (
                [i64p] * 4 + [ctypes.c_int64, i64p] + [ctypes.c_int64] * 6
                + [i64p] * 3 + [ctypes.c_int64])
            _LIB = lib
        return _LIB


def extz2_batch(queries, targets, mat, m, q, e, w, zdrop, flag):
    """Batched ksw_extz2 over pairs; returns [ExtzResult, ...].

    queries/targets: lists of int arrays. All pairs share (mat, m, q, e,
    w, zdrop, flag). Each result equals extz2 on its pair."""
    B = len(queries)
    if B == 0:
        return []
    lib = get_lib()
    qcat = np.concatenate([np.asarray(x, np.int64) for x in queries])
    tcat = np.concatenate([np.asarray(x, np.int64) for x in targets])
    qoff = np.concatenate([[0], np.cumsum([len(x) for x in queries])]
                          ).astype(np.int64)
    toff = np.concatenate([[0], np.cumsum([len(x) for x in targets])]
                          ).astype(np.int64)
    mat_a = np.asarray(mat, np.int64)
    out = np.zeros(B * 9, np.int64)
    cap = max(int(qoff[-1] + toff[-1]) + 16 * B, 1024)
    coff = np.zeros(B + 1, np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    while True:
        cig = np.zeros(cap * 2, np.int64)
        rc = lib.extz2_batch_c(p(qcat), p(qoff), p(tcat), p(toff), B,
                               p(mat_a), m, q, e, w, zdrop, flag, p(out),
                               p(cig), p(coff), cap)
        if rc == 0:
            break
        cap *= 2            # the cigars did not fit: retry with room
    results = []
    for b in range(B):
        ez = ExtzResult()
        (ez.max, ez.max_q, ez.max_t, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
         ez.score, ez.zdropped) = (int(v) for v in out[b * 9:(b + 1) * 9])
        lo, hi = int(coff[b]), int(coff[b + 1])
        ez.cigar = [(int(cig[i * 2]), int(cig[i * 2 + 1]))
                    for i in range(lo, hi)]
        results.append(ez)
    return results
