"""Banded affine-gap DP with traceback — the cigar-generating stage.

Host-side companion of the device SW kernel: the device finds (score, start,
end) for every accepted pair; this module reproduces the reference
`SmithWaterman::banded_sw` (reference src/alignment/StripedSmithWaterman.cpp)
over the [start..end] window to obtain the backtrace ('M'/'I'/'D' string),
byte-for-byte including its tie-breaks:
  - diagonal preferred on ties (temp1 <= temp2 -> match state);
  - between gap states, E (query gap, 'I') only on strict e1 > f1;
  - within E/F, "open" only on strict temp1 > temp2 (else extend);
  - the traceback starts at the window corner and the first window cell is an
    implicit 'M'.
Band width starts at |dbLen - qLen| + 1 and doubles until the banded max
reaches the known score. Values outside the band read as 0 (the reference's
h_b[0]/h_b[edge] boundary resets).

The per-row F dependency is closed with a prefix cummax (exact for
gap_open >= gap_extend), so each row is one vector op sequence instead of a
scalar loop.
"""

import numpy as np

NEG = -(1 << 40)

_NATIVE = None


def _native_lib():
    """Compile-once native fill+traceback (native/banded_bt.cpp); returns
    the ctypes lib or None (numpy fallback keeps working everywhere)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    import ctypes
    import hashlib
    import os
    import subprocess
    _NATIVE = False
    from .. import BUILD_DIR, REPO_ROOT
    # the helper's source lives at the repository root, beside the JAX
    # package; the library is built into the port's git-ignored build dir
    cpp = REPO_ROOT / "native" / "banded_bt.cpp"
    if not cpp.exists():
        return None
    cache = BUILD_DIR
    try:
        cache.mkdir(parents=True, exist_ok=True)
        h = hashlib.sha256(cpp.read_bytes()).hexdigest()[:16]
        so = cache / f"banded_bt_{h}.so"
        if not so.exists():
            # build beside the target and rename: concurrent processes
            # never load a half-written library
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(cpp),
                 "-o", str(tmp)], capture_output=True)
            if r.returncode != 0:
                return None
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.banded_bt_c.restype = ctypes.c_long
        lib.banded_bt_c.argtypes = [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_long] * 6 \
            + [ctypes.c_char_p]
        _NATIVE = lib
        return lib
    except Exception:
        return None


def banded_align(db_win, q_win, comp_bias_win, score, gap_open, gap_extend,
                 sub_matrix):
    """Compute the backtrace for one alignment window.

    db_win, q_win: int arrays of target/query residues inside the window
                   (db_sequence + dbStartPos .. dbEndPos, ditto query).
    comp_bias_win: int8 composition bias per query window position.
    score: the known optimal score (from the device SW pass).
    Returns backtrace string of 'M'/'I'/'D' (query-consuming = M/I).
    """
    s_win = (sub_matrix[q_win][:, db_win].astype(np.int64)
             + np.asarray(comp_bias_win, dtype=np.int64)[:, None])
    return banded_align_scores(db_win, s_win, score, gap_open, gap_extend)


def banded_align_scores(db_win, s_win, score, gap_open, gap_extend):
    """Backtrace for one alignment window from a precomputed (qLen, dbLen)
    per-cell score matrix (substitution columns or profile columns)."""
    dbL = len(db_win)
    s_win = np.asarray(s_win, dtype=np.int64)
    qL = s_win.shape[0]
    go = int(gap_open)
    ge = int(gap_extend)

    band_width = abs(dbL - qL) + 1
    lib = _native_lib()
    if lib is not None:
        import ctypes
        s_c = np.ascontiguousarray(s_win, dtype=np.int64)
        buf = ctypes.create_string_buffer(int(qL + dbL + 2))
        bw = band_width
        while bw <= 2 * max(dbL, qL):
            n = lib.banded_bt_c(
                s_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                qL, dbL, bw, int(score), go, ge, buf)
            if n >= 0:
                return buf.raw[:n].decode()
            if n == -2:
                break            # inconsistency: reproduce via numpy path
            bw *= 2
        if bw > 2 * max(dbL, qL):
            raise RuntimeError("banded_align: score not reached in full band")
    while True:
        ok, dirs = _banded_fill(s_win, qL, dbL, band_width, score, go, ge)
        if ok:
            break
        band_width *= 2
        if band_width > 2 * max(dbL, qL):
            # matches the reference failure mode ("score and position are not
            # consensus") — should not happen when score came from sw_scan
            raise RuntimeError("banded_align: score not reached in full band")
    return _traceback(dirs, qL, dbL)


def _banded_fill(s_win, qL, dbL, bw, score, go, ge):
    """One banded DP fill. Returns (max >= score, direction planes).

    dirs: (qL, dbL, 3) int8, planes [de, df, dh] in full (i, j) coordinates.
    Out-of-band cells are never read by the traceback when ok is True.
    """
    dirs = np.zeros((qL, dbL, 3), dtype=np.int8)
    h_prev = np.zeros(dbL + 2, dtype=np.int64)   # index j+1; 0 outside band
    e_prev = np.zeros(dbL + 2, dtype=np.int64)
    best = 0
    js = np.arange(dbL)
    for i in range(qL):
        beg = max(0, i - bw)
        end = min(dbL - 1, i + bw)
        j = js[beg:end + 1]
        # E: from previous row, same j
        if i == 0:
            t1 = np.full(j.shape, -go, dtype=np.int64)
            t2 = np.full(j.shape, -ge, dtype=np.int64)
        else:
            t1 = h_prev[j + 1] - go
            t2 = e_prev[j + 1] - ge
        e_row = np.maximum(t1, t2)
        dirs[i, j, 0] = np.where(t1 > t2, 3, 2)
        e1 = np.maximum(e_row, 0)
        # diagonal: previous row at j-1 (h_prev[j] due to +1 shift)
        diag = h_prev[j] + s_win[i, j]
        hq = np.maximum(e1, diag)           # H without F; >= 0 via e1
        # F via prefix cummax: chain seeds at the boundary zero (h_c[beg-1]=0)
        n = len(j)
        ramp = np.arange(n, dtype=np.int64) * ge
        # seed[m] = hq[m-1] + (m-1)*ge + ge; seed[0] = 0 is the boundary
        # h_c[beg-1] = 0 term (k = -1), consistent under the same +ge shift
        seed = np.concatenate([[0], hq[:-1] + ramp[:-1] + ge])
        run = np.maximum.accumulate(seed)
        f_open = run - go - ramp
        # pure extension of the initial f=0: f after m steps = -m*ge
        f_ext0 = -ge * (np.arange(n, dtype=np.int64) + 1)
        f_row = np.maximum(f_open, f_ext0)
        f1 = np.maximum(f_row, 0)
        h_row = np.maximum(hq, f1)
        best = max(best, int(h_row.max()) if n else 0)
        # directions for F: open if h_c[j-1] - go > f[j-1] - ge
        hc_left = np.concatenate([[0], h_row[:-1]])
        f_left = np.concatenate([[0], f_row[:-1]])
        dirs[i, j, 1] = np.where(hc_left - go > f_left - ge, 5, 4)
        # direction for H
        t1m = np.maximum(e1, f1)
        dh = np.where(t1m <= diag, 1,
                      np.where(e1 > f1, dirs[i, j, 0], dirs[i, j, 1]))
        dirs[i, j, 2] = dh
        # roll rows
        h_prev = np.zeros(dbL + 2, dtype=np.int64)
        e_prev = np.zeros(dbL + 2, dtype=np.int64)
        h_prev[j + 1] = h_row
        e_prev[j + 1] = e_row
    return best >= score, dirs


def _traceback(dirs, qL, dbL):
    i, j = qL - 1, dbL - 1
    plane = 2
    out = []
    while i > 0 or j > 0:
        d = dirs[i, j, plane]
        if d == 1:
            out.append('M'); i -= 1; j -= 1; plane = 2
        elif d == 2:
            out.append('I'); i -= 1; plane = 0
        elif d == 3:
            out.append('I'); i -= 1; plane = 2
        elif d == 4:
            out.append('D'); j -= 1; plane = 1
        elif d == 5:
            out.append('D'); j -= 1; plane = 2
        else:
            raise RuntimeError(f"banded traceback error at ({i},{j}): {d}")
    out.append('M')   # the (0,0) cell
    return ''.join(reversed(out))
