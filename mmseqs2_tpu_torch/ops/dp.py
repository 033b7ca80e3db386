"""Batched dynamic-programming scans: gapless diagonal scan and affine-gap
Smith-Waterman (score + end positions), as PyTorch column scans.

Port of mmseqs2_tpu/ops/dp.py, the port's oracle: one step processes one
target column for a whole batch of (query, target) pairs, whose per-column
state is a (B, Lq) int32 matrix. sw_scan is the second oracle of the SW
kernel (tests/test_torch_sw.py holds the kernel against it on the card).
gapless_scan is the plain version of the gapless kernel's tracking form
(ops/gapless.py calls it). The within-column affine-gap dependency (Farrar's
lazy-F) is closed exactly with a prefix cummax (valid when gap_open >=
gap_extend).

Numerical contracts reproduced:
  - gapless: saturating-u8 semantics of SmithWaterman::ungapped_alignment
    (reference src/alignment/StripedSmithWaterman.cpp:1817-1876): per-step
    clamp of H to [0, cap].
  - gapped: sw_sse2_byte/word recurrences (StripedSmithWaterman.cpp:99-298)
    with the SWPS3 "no deletion directly after insertion" rule: the E update
    reads the pre-lazy-F H value. End-position tie-breaks: target end = first
    column reaching the global max; query end = smallest query index
    attaining the column max in that column.
"""

import torch

NEG_INF = -(1 << 28)


def _inputs(profiles, qidx, targets):
    profiles = torch.as_tensor(profiles).to(torch.int32)
    qidx = torch.as_tensor(qidx, device=profiles.device).to(torch.int64)
    targets = torch.as_tensor(targets, device=profiles.device).to(torch.int64)
    return profiles, qidx, targets


def gapless_scan(profiles, qidx, targets, caps, with_endpos=False):
    """Best ungapped local alignment score per (query, target) pair.

    profiles: (NQ, A, Lq) int query profiles; qidx: (B,) query index per
    pair; targets: (B, Lt) target residues; caps: (B,) per-pair score cap.
    Returns score (B,) int32 [and (qEnd, tEnd) (B,) if with_endpos]."""
    profiles, qidx, targets = _inputs(profiles, qidx, targets)
    dev = profiles.device
    i32 = torch.int32
    nb, lt = targets.shape
    lq = profiles.shape[2]
    caps = torch.as_tensor(caps, device=dev).to(i32)[:, None]
    H = torch.zeros((nb, lq), dtype=i32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=i32, device=dev)
    best = torch.zeros(nb, dtype=i32, device=dev)
    best_q = torch.full((nb,), lq - 1, dtype=i32, device=dev)
    best_t = torch.full((nb,), -1, dtype=i32, device=dev)
    for j in range(lt):
        s = profiles[qidx, targets[:, j]]
        H = torch.minimum((torch.cat([zero_col, H[:, :-1]], 1) + s)
                          .clamp_(min=0), caps)
        colmax, amax = H.max(1)
        if with_endpos:
            better = colmax > best
            best_t = torch.where(better, j, best_t)
            best_q = torch.where(better, amax.to(i32), best_q)
        best = torch.maximum(best, colmax)
    if with_endpos:
        return best, best_q, best_t
    return best


def sw_scan(profiles, qidx, targets, gap_open, gap_extend):
    """Affine-gap local alignment score and end positions, batched.

    profiles/qidx/targets as in gapless_scan. A gap of length k costs
    gap_open + (k-1)*gap_extend. Returns (score, qEnd, tEnd): (B,) int32
    each; tEnd == -1 when nothing aligned."""
    profiles, qidx, targets = _inputs(profiles, qidx, targets)
    dev = profiles.device
    i32 = torch.int32
    go, ge = int(gap_open), int(gap_extend)
    nb, lt = targets.shape
    lq = profiles.shape[2]
    # ramp for the exact lazy-F closure: F[i] = max_{k<i}(Hng[k] + k*ge)
    #                                           - go - (i-1)*ge
    ramp = torch.arange(lq, dtype=i32, device=dev) * ge
    H = torch.zeros((nb, lq), dtype=i32, device=dev)
    Hng = torch.zeros_like(H)
    E = torch.zeros_like(H)
    zero_col = torch.zeros((nb, 1), dtype=i32, device=dev)
    neg_col = torch.full((nb, 1), NEG_INF, dtype=i32, device=dev)
    best = torch.zeros(nb, dtype=i32, device=dev)
    best_q = torch.full((nb,), lq - 1, dtype=i32, device=dev)
    best_t = torch.full((nb,), -1, dtype=i32, device=dev)
    for j in range(lt):
        s = profiles[qidx, targets[:, j]]
        diag = torch.cat([zero_col, H[:, :-1]], 1) + s
        # E from the previous column's pre-F H (striped SW does not feed
        # lazy-F corrections into E)
        E = torch.maximum(Hng - go, E - ge)
        Hng = torch.maximum(diag, E).clamp_(min=0)
        run = torch.cummax(Hng + ramp, 1).values
        F = torch.cat([neg_col, run[:, :-1]], 1) - go - ramp + ge
        H = torch.maximum(Hng, F)
        colmax, amax = H.max(1)
        better = colmax > best
        best_t = torch.where(better, j, best_t)
        best_q = torch.where(better, amax.to(i32), best_q)
        best = torch.maximum(best, colmax)
    return best, best_q, best_t
