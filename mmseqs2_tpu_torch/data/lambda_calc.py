"""Karlin-Altschul lambda estimation for score matrices without precomputed values.

Solves the Yu-Altschul system (reference src/commons/LambdaCalculation.cpp):
find lambda > 0 and probabilities p (p == q, symmetric matrices) such that

    sum_j exp(lambda * S[i][j]) * p[j] = 1   for all i      (Y(lambda) p = 1)
    sum_i p[i] = 1                                           (restriction)

p(lambda) = Y(lambda)^{-1} @ ones; the restriction value f(lambda) = sum(p) - 1
is monotone near the root; we bracket and bisect.
"""

import numpy as np


def _restriction(S: np.ndarray, lam: float):
    Y = np.exp(lam * S)
    try:
        p = np.linalg.solve(Y, np.ones(S.shape[0]))
    except np.linalg.LinAlgError:
        return None, None
    return float(p.sum()) - 1.0, p


def estimate_lambda_and_background(S: np.ndarray, eps: float = 1e-12):
    """Return (lambda, p) for half-bit float score matrix S (X excluded)."""
    S = np.asarray(S, dtype=np.float64)
    # The valid root is the one where p = Y^{-1} 1 is a non-negative
    # probability vector; scan a dense lambda grid and keep the bracket whose
    # solution stays non-negative (for half-bit matrices the root is near
    # ln(2)/2 ~ 0.3466).
    lo = hi = f_lo = None
    prev_lam = prev_f = None
    for lam in np.geomspace(0.01, 16.0, 600):
        f, p = _restriction(S, lam)
        if f is None or not np.isfinite(f):
            prev_lam = prev_f = None
            continue
        if prev_f is not None and np.sign(f) != np.sign(prev_f):
            lo, hi, f_lo = prev_lam, lam, prev_f
            # keep scanning: the valid root is the largest sign change
        prev_lam, prev_f = lam, f
    if lo is None:
        raise ValueError("Could not bracket lambda for matrix")
    # bisection
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        f, p = _restriction(S, mid)
        if f is None:
            raise ValueError("Singular system during lambda bisection")
        if abs(f) < eps or (hi - lo) < eps:
            break
        if np.sign(f) == np.sign(f_lo):
            lo, f_lo = mid, f
        else:
            hi = mid
    _, p = _restriction(S, mid)
    p = np.clip(p, 0.0, None)
    p = p / p.sum()
    return mid, p
