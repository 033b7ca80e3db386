"""Gapless Karlin-Altschul parameters (lambda, K, H) from a scoring system.

Used as fallback when no precomputed ALP parameter set exists
(reference falls back to a full ALP simulation, lib/alp; porting that
simulation is a TODO — this gapless analytic path covers gapless stats and
approximates gapped ones conservatively).

Lambda: unique positive root of sum_ij p_i p_j exp(lambda * s_ij) = 1.
H: relative entropy = lambda * sum_ij p_i p_j s_ij exp(lambda s_ij).
K: computed with the classic Karlin-Altschul lattice recursion over partial
sums (as in BLAST's BlastKarlinLHtoK).
"""

import math

import numpy as np


def _score_distribution(submat):
    """Probability of each integer score under background x background."""
    S = submat.sub_matrix.astype(np.int64)
    p = submat.pback
    n = submat.alphabet_size - 1  # exclude X
    S = S[:n, :n]
    pp = np.outer(p[:n], p[:n])
    pp = pp / pp.sum()
    lo, hi = int(S.min()), int(S.max())
    probs = np.zeros(hi - lo + 1)
    for s in range(lo, hi + 1):
        probs[s - lo] = pp[S == s].sum()
    return lo, hi, probs


def gapless_params(submat):
    lo, hi, probs = _score_distribution(submat)
    scores = np.arange(lo, hi + 1, dtype=np.float64)
    if hi <= 0 or probs @ scores >= 0:
        raise ValueError("Invalid scoring system for Karlin-Altschul stats")

    def f(lam):
        return float(np.sum(probs * np.exp(lam * scores))) - 1.0

    lo_l, hi_l = 1e-6, 1.0
    while f(hi_l) < 0:
        hi_l *= 2.0
        if hi_l > 100:
            raise ValueError("Lambda diverged")
    for _ in range(200):
        mid = 0.5 * (lo_l + hi_l)
        if f(mid) > 0:
            hi_l = mid
        else:
            lo_l = mid
    lam = 0.5 * (lo_l + hi_l)

    ew = np.exp(lam * scores)
    H = lam * float(np.sum(probs * scores * ew))

    K = _karlin_k(lo, hi, probs, lam, H)
    return lam, K, H


def _karlin_k(lo, hi, probs, lam, H, iterations=50, sumlimit=0.0001):
    """BLAST-style K computation via partial-sum recursion."""
    # delta = gcd of scores with nonzero probability
    nz = [s for s, p in zip(range(lo, hi + 1), probs) if p > 0]
    d = 0
    for s in nz:
        d = math.gcd(d, abs(s))
    d = max(d, 1)
    lo_d, hi_d = lo // d, hi // d
    probs_d = np.zeros(hi_d - lo_d + 1)
    for s, p in zip(range(lo, hi + 1), probs):
        if p > 0:
            probs_d[s // d - lo_d] += p
    lam_d = lam * d
    H_d = H / d

    if lo_d == -1 and hi_d == 1:
        # simple +-1 lattice closed form
        K = (probs_d[0] - probs_d[-1]) ** 2 / probs_d[0]
        return K * d  # undo scaling below (delta folded back)

    # general case: sum over number of terms of P(first passage)
    sigma = 0.0
    # distribution of partial sums S_k, tracked on a lattice
    span = (hi_d - lo_d) * iterations + 1
    base = -lo_d * iterations
    cur = np.zeros(span)
    cur[base] = 1.0  # S_0 = 0
    for k in range(1, iterations + 1):
        new = np.zeros(span)
        for s_idx, p in enumerate(probs_d):
            if p <= 0:
                continue
            s = lo_d + s_idx
            if s >= 0:
                new[s:] += p * cur[: span - s] if s > 0 else p * cur
            else:
                new[: span + s] += p * cur[-s:]
        cur = new
        # contribution: E[exp(lam*S_k); S_k < 0] + P(S_k >= 0 terms weighted)
        idx = np.arange(span) - base
        neg = idx < 0
        pos = ~neg
        term = float(np.sum(cur[neg] * np.exp(lam_d * idx[neg]))) + float(
            np.sum(cur[pos] * 0.0)
        )
        # standard recursion uses E[e^{lam S_k}; S_k<0] + P(S_k>=0)
        term += float(cur[pos].sum())
        sigma += term / k
        if term / k < sumlimit:
            break
    C = math.exp(-2.0 * sigma)
    if lo_d == -1 or hi_d == 1:
        if hi_d == 1:
            K = C * H_d / lam_d * (1 - math.exp(-lam_d))
        else:
            avg = float(np.sum(probs_d * np.arange(lo_d, hi_d + 1)))
            K = C * lam_d * avg / (1 - math.exp(-lam_d)) if avg != 0 else C
        return K / d * d
    # general: K = C * lam_d * H_d / ... use standard approximation
    K = C * H_d * lam_d / ((1.0 - math.exp(-lam_d)) ** 2)
    return K
