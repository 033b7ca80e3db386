"""Sequence encoding, padding/length-bucketing, and composition-bias correction.

TPU-first rationale: XLA requires static shapes, so variable-length sequences
are padded into length buckets (multiples of SUBLANE-friendly sizes). Padding
residues map to a dedicated PAD index whose substitution scores are the most
negative representable value, so padded columns can never contribute to a
local alignment.

Reference behavior being reproduced:
  - composition bias: SubstitutionMatrix::calcLocalAaBiasCorrection
    (reference src/commons/SubstitutionMatrix.cpp), a +-20 residue
    window average correction per query position, float32.
  - int8 rounding of the bias for profiles: (b < 0) ? b - 0.5 : b + 0.5
    truncated toward zero (ssw_init,
    reference src/alignment/StripedSmithWaterman.cpp:1364-1385).
"""

import numpy as np


def bucket_length(n: int, minimum: int = 32) -> int:
    """Round length up to the next power of two.

    Pure powers of two keep the distinct-jit-shape count LOW: on the TPU
    runtime each new shape pays ~1.5s of tracing plus a remote compile, so
    at real-data length spreads a finer bucketing (e.g. multiples of 128)
    costs minutes of compiles to save <2x padded cells — a bad trade, the
    padded columns are nearly free."""
    n = max(int(n), 1)
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_batch(seqs, pad_value: int, length: int = None):
    """Stack variable-length uint8 arrays into (B, L) with PAD fill.

    Returns (padded (B,L) uint8, lengths (B,) int32).
    """
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = length or bucket_length(int(lens.max()) if len(lens) else 1)
    out = np.full((len(seqs), L), pad_value, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lens


def calc_local_aa_bias(seq_num: np.ndarray, sub_matrix: np.ndarray,
                       pback: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Composition bias correction per query position (float32).

    Mirrors SubstitutionMatrix::calcLocalAaBiasCorrection: for each position i,
    bias[i] = scale * ( -avg(subMat[aa_i][window]) + sum_a pBack[a]*subMat[aa_i][a] )
    over a +-20 window (excluding i itself from the sum, length = window span).
    """
    N = len(seq_num)
    if N == 0:
        return np.zeros(0, dtype=np.float32)
    w = 40
    mat = sub_matrix.astype(np.int32)
    row = mat[seq_num]                       # (N, alpha) scores vs each letter
    # sum of subMat[aa_i][aa_j] over the window around i
    pair = row[:, seq_num] if N <= 4096 else None
    if pair is not None:
        # windowed sums via cumulative sums over j
        cs = np.concatenate([np.zeros((N, 1), np.int64),
                             np.cumsum(pair, axis=1, dtype=np.int64)], axis=1)
        idx = np.arange(N)
        lo = np.maximum(0, idx - w // 2)
        hi = np.minimum(N, idx + w // 2)
        win_sum = cs[idx, hi] - cs[idx, lo]
        win_len = (hi - lo).astype(np.float32)
        own = pair[idx, idx]
    else:
        win_sum = np.empty(N, dtype=np.int64)
        win_len = np.empty(N, dtype=np.float32)
        own = np.empty(N, dtype=np.int64)
        for i in range(N):
            lo = max(0, i - w // 2)
            hi = min(N, i + w // 2)
            s = mat[seq_num[i]][seq_num[lo:hi]]
            win_sum[i] = s.sum()
            win_len[i] = hi - lo
            own[i] = mat[seq_num[i]][seq_num[i]]
    delta = (win_sum - own).astype(np.float32) / (-1.0 * win_len)
    back = (mat.astype(np.float32) * pback.astype(np.float32)[None, :]).sum(axis=1)
    delta += back[seq_num]
    return (scale * delta).astype(np.float32)


def round_bias_i8(bias_f32: np.ndarray) -> np.ndarray:
    """(int8)((b < 0) ? b - 0.5 : b + 0.5) with C truncation toward zero."""
    shifted = np.where(bias_f32 < 0.0, bias_f32 - 0.5, bias_f32 + 0.5)
    return np.trunc(shifted).astype(np.int8)


def make_query_profile(seq_num: np.ndarray, sub_matrix: np.ndarray,
                       comp_bias_i8: np.ndarray = None,
                       pad_len: int = None, alpha_pad: int = 32) -> np.ndarray:
    """Build a (alpha_pad, Lpad) int32 query profile:
    profile[t, i] = subMat[seq[i], t] (+ comp_bias[i]).

    Padded query columns score a very negative value; padded alphabet rows
    (e.g. the PAD target letter) likewise, so padding cannot extend alignments.
    """
    L = len(seq_num)
    Lp = pad_len or bucket_length(L)
    alpha = sub_matrix.shape[0]
    NEG = np.int32(-1 << 20)
    prof = np.full((alpha_pad, Lp), NEG, dtype=np.int32)
    block = sub_matrix[seq_num, :].T.astype(np.int32)   # (alpha, L)
    if comp_bias_i8 is not None:
        block = block + comp_bias_i8.astype(np.int32)[None, :]
    prof[:alpha, :L] = block
    return prof
