"""HH-suite style MSA diversity filter.

Port of mmseqs2_tpu/profile/filter.py.
Reference: src/alignment/MsaFilter.cpp — coverage / query-score / query-id
pre-filters, then iterative position-dependent maximum-pairwise-identity
selection that raises the seqid threshold until at least Ndiff sequences
cover every window.
"""

import numpy as np

from .msa import ANY, GAP, NAA

PLTY_GAPOPEN = np.float32(6.0)
PLTY_GAPEXTD = np.float32(1.0)


def filter_msa(msa: np.ndarray, sub_matrix: np.ndarray, coverage: int = 0,
               qid: int = 0, qsc: float = -20.0, max_seqid: int = 90,
               Ndiff: int = 1000, filter_min_enable: int = 0):
    """Returns (keep bool array over rows, filtered size). Row 0 (query) is
    always kept. Single-bucket (--qid single value) variant."""
    X = msa.astype(np.int32)
    N_in, L = X.shape
    keep = np.zeros(N_in, dtype=np.int8)
    if N_in < filter_min_enable:
        keep[:] = 1
        keep[0] = 2
        return keep != 0, N_in

    keep[0] = 2
    keep[1:] = 1
    in_ = np.where(keep == 2, 2, 0).astype(np.int8)
    n = int((keep == 2).sum())

    is_res = X < NAA
    first = np.argmax(is_res, axis=1)
    last = L - 1 - np.argmax(is_res[:, ::-1], axis=1)
    no_res = ~is_res.any(axis=1)
    first[no_res] = L
    last[no_res] = 0
    nres = is_res.sum(axis=1)
    keep[nres == 0] = 0

    # sort rows 1.. by nres desc (stable)
    order = np.concatenate([[0], 1 + np.argsort(-nres[1:], kind="stable")])
    ksort = order
    inkk = in_[ksort].copy()

    N = np.zeros(L, dtype=np.int64)
    N[first[0]: last[0] + 1] = 1
    Nmax = np.zeros(L, dtype=np.int64)
    idmaxwin = np.full(L, -1, dtype=np.int64)
    seqid_prev = np.full(N_in, -1, dtype=np.int64)
    seqid1 = 20
    if Ndiff <= 0 or Ndiff >= N_in:
        seqid1 = max_seqid
        Ndiff = N_in
    diffNmax = Ndiff

    # one-shot rejections: coverage, qsc, qid
    for k in range(N_in):
        if keep[k] in (0, 2):
            continue
        if 100 * nres[k] < coverage * L:
            keep[k] = 0
            continue
        if qsc > -10:
            qsc_min = np.float32(qsc) * np.float32(nres[k])
            qsc_sum = np.float32(0.0)
            gapq = gapk = 0
            for i in range(first[k], last[k] + 1):
                xk = X[k, i]
                xq = X[0, i]
                if xk < 20:
                    gapk = 0
                    if xq < 20:
                        gapq = 0
                        qsc_sum = np.float32(
                            qsc_sum + np.float32(sub_matrix[xq, xk]))
                    elif xq == ANY:
                        continue
                    else:
                        qsc_sum = np.float32(
                            qsc_sum - (PLTY_GAPEXTD if gapq else
                                       PLTY_GAPOPEN))
                        gapq += 1
                elif xk == ANY:
                    continue
                elif xq < 20:
                    gapq = 0
                    qsc_sum = np.float32(
                        qsc_sum - (PLTY_GAPEXTD if gapk else PLTY_GAPOPEN))
                    gapk += 1
            if qsc_sum < qsc_min:
                keep[k] = 0
                continue
        qdiff_max_frac = 0.9999 - 0.01 * qid
        if qdiff_max_frac < 0.999:
            qdiff_max = int(qdiff_max_frac * nres[k] + 0.9999)
            span = slice(first[k], last[k] + 1)
            diffs = ((X[k, span] < NAA) & (X[k, span] != X[0, span])).sum()
            if diffs >= qdiff_max:
                keep[k] = 0
                continue

    nn = int((keep > 0).sum())
    if nn == 0:
        for k in range(N_in):
            keep[k] = 1
            break

    if seqid1 > max_seqid:
        return keep != 0, nn

    WFIL = 25
    seqid = seqid1
    seqid_step = 0
    diffNmax_prev = 0
    while seqid <= max_seqid:
        stop = True
        diffNmax_prev = diffNmax
        diffNmax = 0
        for i in range(L):
            lo = max(0, min(L - 2 * WFIL + 1, i - WFIL))
            hi = min(L, max(2 * WFIL, i + WFIL))
            m = int(N[lo:hi].max()) if hi > lo else 0
            if Nmax[i] < m:
                Nmax[i] = m
            if Nmax[i] < Ndiff:
                stop = False
                idmaxwin[i] = seqid
                if diffNmax < Ndiff - Nmax[i]:
                    diffNmax = Ndiff - Nmax[i]
        if stop:
            break

        for kk in range(N_in):
            if inkk[kk]:
                continue
            k = int(ksort[kk])
            if not keep[k]:
                continue
            if keep[k] == 2:
                inkk[kk] = 2
                continue
            if seqid >= 100:
                in_[k] = inkk[kk] = 1
                n += 1
                continue
            seqidk = seqid1
            span = idmaxwin[first[k]: last[k] + 1]
            if len(span):
                seqidk = max(seqidk, int(span.max()))
            if seqid == seqid_prev[k]:
                continue
            seqid_prev[k] = seqid
            diff_min_frac = 0.9999 - 0.01 * seqidk
            accepted = True
            for jj in range(kk):
                if not inkk[jj]:
                    continue
                j = int(ksort[jj])
                first_kj = max(first[k], first[j])
                last_kj = min(last[k], last[j])
                cov_kj = last_kj - first_kj + 1
                diff_suff = int(diff_min_frac * min(nres[k], cov_kj) + 0.999)
                span = slice(first_kj, last_kj + 1)
                xk = X[k, span]
                xj = X[j, span]
                no_aa = (xk > NAA - 1) | (xj > NAA - 1)
                cov_kj -= int(no_aa.sum())
                diff = int((~no_aa & (xk != xj)).sum())
                if diff < diff_suff and diff <= diff_min_frac * cov_kj \
                        and cov_kj > 0:
                    accepted = False
                    break
            if accepted:
                in_[k] = inkk[kk] = 1
                n += 1
                N[first[k]: last[k] + 1] += 1

        seqid_step = max(1, min(5, diffNmax
                                // (diffNmax_prev - diffNmax + 1)
                                * seqid_step // 2))
        seqid += seqid_step

    keep = in_.copy()
    return keep != 0, int((keep != 0).sum())
