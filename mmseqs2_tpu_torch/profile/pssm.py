"""PSSM computation from an MSA — position-based sequence weighting,
HH-suite context-specific weights, Neff, substitution pseudocounts, log-odds
quantization.

Port of mmseqs2_tpu/profile/pssm.py.
Reference: src/alignment/PSSMCalculator.cpp. Float32 semantics preserved
(including the flog2/fpow2 approximations and f32 accumulation order per
accumulator) so the int8 PSSM matches the reference byte-for-byte.
"""

import numpy as np

from .mathx import convert_neff_to_char, flog2, fpow2
from .msa import ANY, ENDGAP, GAP, NAA

PROFILE_AA_SIZE = 20


def fsum32(arr) -> np.float32:
    """Sequential float32 sum (C accumulation order; np.sum is pairwise)."""
    a = np.asarray(arr, dtype=np.float32).ravel()
    if a.size == 0:
        return np.float32(0.0)
    return np.cumsum(a, dtype=np.float32)[-1]


def normalize_to_1(arr, default=None):
    s = fsum32(arr)
    if s != 0.0:
        # C: float fac = 1.0 / sum  (double divide, rounded to float)
        fac = np.float32(np.float64(1.0) / np.float64(s))
        return (arr * fac).astype(np.float32)
    if default is not None:
        return default.astype(np.float32).copy()
    return arr


def compute_sequence_weights(msa: np.ndarray) -> np.ndarray:
    """Henikoff position-based weights (computeSequenceWeights)."""
    n, L = msa.shape
    weights = np.full(n, 1e-6, dtype=np.float32)
    number_res = (msa != GAP).sum(axis=1).astype(np.float32)
    for pos in range(L):
        col = msa[:, pos]
        valid = col != GAP
        aa_col = np.where(valid & (col < PROFILE_AA_SIZE), col, PROFILE_AA_SIZE)
        nl = np.bincount(aa_col[aa_col < PROFILE_AA_SIZE],
                         minlength=PROFILE_AA_SIZE)
        distinct = int((nl > 0).sum())
        if distinct == 0:
            continue
        contrib = np.zeros(n, dtype=np.float32)
        sel = valid & (col < PROFILE_AA_SIZE)
        contrib[sel] = (np.float32(1.0) /
                        (nl[col[sel]].astype(np.float32)
                         * np.float32(distinct)
                         * (number_res[sel] + np.float32(30.0))))
        weights = (weights + contrib).astype(np.float32)
    return weights


def compute_match_weights(msa, seq_weight, pback):
    """Weighted per-position frequencies, normalized against background."""
    n, L = msa.shape
    w = np.zeros((L, PROFILE_AA_SIZE), dtype=np.float32)
    for k in range(n):
        row = msa[k]
        sel = (row != GAP) & (row < PROFILE_AA_SIZE)
        pos = np.nonzero(sel)[0]
        w[pos, row[pos]] = (w[pos, row[pos]] + seq_weight[k]).astype(
            np.float32)
    pb = pback[:PROFILE_AA_SIZE].astype(np.float32)
    for pos in range(L):
        w[pos] = normalize_to_1(w[pos], pb)
    return w


def compute_neff_m(match_weight, seq_weight, msa):
    n, L = msa.shape
    freq = match_weight
    ent = np.zeros(L, dtype=np.float32)
    mask = freq > np.float32(1e-10)
    logs = flog2(freq)
    terms = np.where(mask, freq * logs, np.float32(0.0)).astype(np.float32)
    ent = -np.cumsum(terms, axis=1, dtype=np.float32)[:, -1]
    neff_hmm = fsum32(fpow2(ent)) / np.float32(L)
    nlim = np.float32(max(10.0, neff_hmm + 1.0))
    scale = flog2(np.float32((nlim - neff_hmm) / (nlim - np.float32(1.0))))
    not_gap = (msa != GAP)
    gated = np.where(not_gap, seq_weight[:, None],
                     np.float32(0.0)).astype(np.float32)
    w_m = (np.float32(-1.0) / np.float32(n)
           + np.cumsum(gated, axis=0, dtype=np.float32)[-1])
    neff = np.where(w_m < 0, np.float32(1.0),
                    nlim - (nlim - np.float32(1.0)) * fpow2(scale * w_m))
    return neff.astype(np.float32)


def compute_context_specific_weights(msa, wg, pback):
    """HH-suite position-specific weights (computeContextSpecificWeights).

    msa is modified conceptually with ENDGAP at terminal gaps; we copy.
    Returns (match_weight (L,20), neff (L,)).
    """
    n, L = msa.shape
    X = msa.astype(np.int32).copy()
    for k in range(n):
        row = X[k]
        i = 0
        while i < L and row[i] == GAP:
            row[i] = ENDGAP
            i += 1
        i = L - 1
        while i >= 0 and row[i] == GAP:
            row[i] = ENDGAP
            i -= 1

    MAXENDGAPFRAC = 0.1
    NCOLMIN = 20
    match_weight = np.zeros((L, PROFILE_AA_SIZE), dtype=np.float32)
    neff = np.zeros(L, dtype=np.float32)
    wi = np.zeros(n, dtype=np.float32)
    # n_counts[j][a]: counts over currently included sequences
    counts = np.zeros((L, ENDGAP + 1), dtype=np.int32)
    included = np.zeros(n, dtype=bool)
    nseqi = 0
    onehot = np.zeros((n, L, 1), dtype=np.int32)   # placeholder unused
    pb = pback[:PROFILE_AA_SIZE].astype(np.float32)

    row_onehots = [None] * n

    def row_counts(k):
        if row_onehots[k] is None:
            oh = np.zeros((L, ENDGAP + 1), dtype=np.int32)
            oh[np.arange(L), X[k]] = 1
            row_onehots[k] = oh
        return row_onehots[k]

    prev_neff = np.float32(0.0)
    for i in range(L):
        change = False
        for k in range(n):
            inc_now = X[k, i] < ANY
            inc_prev = included[k]
            if inc_now and not inc_prev:
                change = True
                nseqi += 1
                counts += row_counts(k)
                included[k] = True
            elif not inc_now and inc_prev:
                change = True
                nseqi -= 1
                counts -= row_counts(k)
                included[k] = False
        if change:
            wi[:] = np.float32(1e-8)
            endgap_col = counts[:, ENDGAP]
            ok = endgap_col <= MAXENDGAPFRAC * nseqi
            jmin = 0
            while jmin < L and not ok[jmin]:
                jmin += 1
            jmax = L - 1
            while jmax >= 0 and not ok[jmax]:
                jmax -= 1
            ncol = jmax - jmin + 1
            if ncol < NCOLMIN:
                wi = np.where(X[:, i] < ANY, wg, np.float32(0.0)).astype(
                    np.float32)
            else:
                sl = slice(jmin, jmax + 1)
                nblock = counts[sl, :ANY]                      # (ncol, 20)
                naa = (nblock > 0).sum(axis=1).astype(np.float32)
                # w_contrib = 1/(n*naa) via rcpps + one Newton-Raphson
                # iteration (PSSMCalculator.cpp simdf32_rcp block) — the
                # approximation differs from an exact divide in the last ulp
                from ..native import nr_rcp
                res = (nblock.astype(np.float32)
                       * naa[:, None]).astype(np.float32)
                vals = nr_rcp(np.where(nblock > 0, res, np.float32(1.0)))
                w_contrib = np.where(nblock > 0, vals,
                                     np.float32(0.0)).astype(np.float32)
                # wi[k] = sum over j of w_contrib[j, X[k, j]]
                for k in range(n):
                    if X[k, i] >= ANY:
                        continue
                    xs = X[k, jmin: jmax + 1]
                    valid = xs < ANY
                    # the reference seeds wi[k] = 1e-8 and then += each
                    # w_contrib term in j order — the seed participates in
                    # the float rounding from the first add on
                    terms = np.concatenate(
                        [[np.float32(1e-8)],
                         w_contrib[np.nonzero(valid)[0], xs[valid]]])
                    wi[k] = fsum32(terms)
            # Neff at i
            f = np.zeros((ncol if ncol > 0 else 0, ANY), dtype=np.float32)
            if ncol > 0:
                for k in range(n):
                    if X[k, i] >= ANY:
                        continue
                    xs = X[k, jmin: jmax + 1]
                    valid = xs < ANY
                    idx = np.nonzero(valid)[0]
                    f[idx, xs[valid]] = (f[idx, xs[valid]] + wi[k]).astype(
                        np.float32)
                sums = np.cumsum(f, axis=1, dtype=np.float32)[:, -1]
                nz = sums != 0
                facs = (np.float64(1.0)
                        / sums[nz].astype(np.float64)).astype(np.float32)
                f[nz] = (f[nz] * facs[:, None]).astype(np.float32)
                mask = f > np.float32(1e-10)
                terms = np.where(mask, f * flog2(f),
                                 np.float32(0.0)).astype(np.float32)
                ent = -fsum32(terms)
                neff_i = np.float32(fpow2(np.float32(ent / ncol)))
            else:
                neff_i = np.float32(1.0)
            neff[i] = neff_i
            prev_neff = neff_i
        else:
            neff[i] = np.float32(0.0) if i == 0 else prev_neff

        col = X[:, i]
        sel = col < PROFILE_AA_SIZE
        mw = np.zeros(PROFILE_AA_SIZE, dtype=np.float32)
        for k in np.nonzero(sel)[0]:
            mw[col[k]] = np.float32(mw[col[k]] + wi[k])
        match_weight[i] = normalize_to_1(mw, pb)
    return match_weight, neff


def prepare_pseudo_counts(freq, R):
    """R: (20, 20) float32 conditional matrix; freq (L, 20).

    PSSMCalculator::preparePseudoCounts uses ScalarProd20
    (lib/simd/simd.h:905, SSE path): per 4-float lane
    lane_j = ((p_j + p_{4+j}) + (p_{8+j} + p_{12+j})) + p_{16+j},
    then (lane0+lane1) + (lane2+lane3) — replicate that float32 summation
    tree exactly (a plain matmul's pairwise sums differ by 1 ulp on
    occasion, which flips the +-0.5 rounding in the 8-bit profile), with
    the native helper (native/pssm_kernels.c)."""
    from ..native import scalar_prod20
    return scalar_prod20(R, freq)


def compute_pseudo_counts(freq, freq_pc, neff, pca, pcb):
    """PSSMCalculator::computePseudoCounts — note the mixed precision:
    tau = (float)fmin(1.0, (double)pca / (1.0 + (double)(float)(Neff/pcb)));
    pseudo = tau * fpc (float); signal = (double)(1.0 - tau) * freq, cast
    back to float; profile = signal + pseudo (float)."""
    nf = (neff.astype(np.float32) / np.float32(pcb)).astype(np.float32)
    tau = np.minimum(
        np.float64(1.0),
        np.float64(np.float32(pca)) / (np.float64(1.0)
                                       + nf.astype(np.float64))
    ).astype(np.float32)
    pseudo = (tau[:, None] * freq_pc.astype(np.float32)).astype(np.float32)
    signal = ((np.float64(1.0) - tau.astype(np.float64))[:, None]
              * freq.astype(np.float64)).astype(np.float32)
    return (signal + pseudo).astype(np.float32)


def compute_consensus(freq, pback, num2aa):
    L = freq.shape[0]
    out = np.empty(L, dtype=np.uint8)
    pb = pback[:PROFILE_AA_SIZE].astype(np.float32)
    for pos in range(L):
        diff = freq[pos] - pb
        maxa = ANY
        maxw = np.float32(1e-8)
        a = int(np.argmax(diff))
        if diff[a] > maxw:
            maxa = a
        out[pos] = ord(num2aa[maxa])
    return out


def compute_log_pssm(freq, pback, bit_factor=8.0, score_bias=0.0):
    # aaProb / subMat->pBack[aa]: float / DOUBLE -> double, then narrowed to
    # float at the flog2(float) call boundary (computeLogPSSM)
    pb = pback[:PROFILE_AA_SIZE].astype(np.float64)
    logp = flog2((freq.astype(np.float64) / pb[None, :]).astype(np.float32))
    v = np.float32(bit_factor) * logp + np.float32(bit_factor * score_bias)
    v = np.where(v < 0.0, v - np.float32(0.5), v + np.float32(0.5))
    # C: float -> char conversion truncates toward zero
    v = np.trunc(v)
    v = np.clip(v, -128.0, 127.0)
    return v.astype(np.int8)


def compute_pssm_from_msa(msa, submat, wg=False, pca=1.1, pcb=4.1,
                          score_bias=0.0):
    """Full pipeline; returns dict with pssm (L,20) int8, profile freqs,
    neff, consensus (ascii)."""
    n, L = msa.shape
    seq_weight = compute_sequence_weights(msa)
    seq_weight = normalize_to_1(seq_weight)
    if not wg:
        match_weight, neff = compute_context_specific_weights(
            msa, seq_weight, submat.pback)
    else:
        match_weight = compute_match_weights(msa, seq_weight, submat.pback)
        neff = compute_neff_m(match_weight, seq_weight, msa)
    consensus = compute_consensus(match_weight, submat.pback, submat.num2aa)
    if pca > 0.0:
        R = submat.sub_matrix_pseudo_counts[:PROFILE_AA_SIZE,
                                            :PROFILE_AA_SIZE].astype(
            np.float32)
        freq_pc = prepare_pseudo_counts(match_weight, R)
        profile = compute_pseudo_counts(match_weight, freq_pc, neff, pca, pcb)
    else:
        profile = match_weight
    pssm = compute_log_pssm(profile, submat.pback, 8.0, score_bias)
    return {"pssm": pssm, "profile": profile, "neff": neff,
            "consensus": consensus}


def profile_to_buffer(pssm, center_num, consensus_ascii, neff, aa2num):
    """25-byte-per-position profile DB payload (Profile::toBuffer)."""
    L = pssm.shape[0]
    out = np.zeros((L, 25), dtype=np.uint8)
    out[:, :20] = pssm.view(np.uint8)
    out[:, 20] = center_num
    out[:, 21] = [aa2num[chr(c)] for c in consensus_ascii]
    out[:, 22] = convert_neff_to_char(neff)
    # 23/24: gap penalties (gDel/gIns), zero without GAP_POS_SCORING
    return out.tobytes()
