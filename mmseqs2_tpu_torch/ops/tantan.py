"""tantan low-complexity masking, ported from the reference's vendored lib.

Reference: lib/tantan/tantan.cpp (Frith 2010, MPL-2.0 —
reimplemented here from its algorithm, gap-free path only, since MMseqs2
calls it with firstGapProb = otherGapProb = 0; Masker.cpp:22-31):

  A position is masked when its posterior repeat probability >= minMaskProb
  under an HMM with one background state and `maxRepeatOffset` (50) repeat
  states, transition structure
      b2b = 1 - repeatProb,  f2b = repeatEndProb,  f2f0 = 1 - repeatEndProb,
      b2f[i] = repeatProb * firstOffsetProb * decay^i,
  and emission likelihood-ratios lr[a][b] = P(a,b)/(p(a) p(b)) against the
  letter `offset` positions back. Forward/backward in float64 with the same
  rescale-every-16-positions scheme (scaleStepSize=16) so floating point
  matches the reference bit-for-bit; posteriors are truncated to float32
  like the reference's `float *probabilities`.

Vectorized across a batch of sequences (numpy) — each step processes a
(B, maxRepeatOffset) state matrix.
"""

import numpy as np

SCALE_STEP = 16


def likelihood_ratio_matrix(submat) -> np.ndarray:
    """ProbabilityMatrix (reference src/commons/BaseMatrix.h:82-95)."""
    prob = submat.prob_matrix
    pb = submat.pback
    return prob / (pb[:, None] * pb[None, :])


def first_repeat_offset_prob(prob_mult: float, max_offset: int) -> float:
    if prob_mult != 1.0:
        return (1.0 - prob_mult) / (1.0 - prob_mult ** max_offset)
    return 1.0 / max_offset


def repeat_probs(seqs: np.ndarray, lens: np.ndarray, lr: np.ndarray,
                 max_offset: int = 50, repeat_prob: float = 0.005,
                 repeat_end_prob: float = 0.05, decay: float = 0.9,
                 min_mask_prob: float = 0.9) -> np.ndarray:
    """Posterior repeat probability per position for a padded batch.

    seqs: (B, L) int letters (padded tail ignored via lens).
    Returns (B, L) float32 posteriors.
    """
    B, L = seqs.shape
    b2b = 1.0 - repeat_prob
    f2b = repeat_end_prob
    f2f0 = 1.0 - repeat_end_prob
    b2f = repeat_prob * first_repeat_offset_prob(decay, max_offset) * \
        decay ** np.arange(max_offset)

    fg = np.zeros((B, max_offset))
    bg = np.ones(B)
    fwd_bg = np.zeros((B, L))
    n_scales = max(1, (L + SCALE_STEP - 1) // SCALE_STEP)
    scales = np.ones((B, n_scales))
    offs = np.arange(max_offset)

    def lr_row(t):
        # emission likelihood ratios at position t vs letters t-1-i
        cur = seqs[:, t]
        if t >= max_offset:           # no boundary mask needed
            return lr[cur[:, None], seqs[:, t - 1 - offs]]
        back_idx = t - 1 - offs
        valid = back_idx >= 0
        back = seqs[:, np.maximum(back_idx, 0)]
        return np.where(valid[None, :], lr[cur[:, None], back], 0.0)

    for t in range(L):
        active = t < lens                                 # (B,) freeze done seqs
        lrow = lr_row(t)
        fromF = fg.sum(axis=1)
        fg_new = (bg[:, None] * b2f[None, :] + fg * f2f0) * lrow
        bg_new = bg * b2b + fromF * f2b
        if t % SCALE_STEP == SCALE_STEP - 1:
            s = np.where(active & (bg_new > 0), 1.0 / np.where(bg_new > 0,
                                                               bg_new, 1.0),
                         1.0)
            scales[:, t // SCALE_STEP] = s
            bg_new = bg_new * s
            fg_new = fg_new * s[:, None]
        bg = np.where(active, bg_new, bg)
        fg = np.where(active[:, None], fg_new, fg)
        fwd_bg[:, t] = bg

    z = bg * b2b + fg.sum(axis=1) * f2b

    post = np.zeros((B, L), dtype=np.float32)
    bg = np.full(B, b2b)
    fg = np.full((B, max_offset), f2b)
    for t in range(L - 1, -1, -1):
        active = t < lens
        nr = fwd_bg[:, t] * bg / z
        post[:, t] = (1.0 - nr.astype(np.float32)).astype(np.float32)
        if t % SCALE_STEP == SCALE_STEP - 1:
            s = np.where(active, scales[:, t // SCALE_STEP], 1.0)
            bg = bg * s
            fg = fg * s[:, None]
        lrow = lr_row(t)
        toB = f2b * bg
        f = fg * lrow
        toF = (b2f[None, :] * f).sum(axis=1)
        fg_new = toB[:, None] + f2f0 * f
        bg_new = bg * b2b + toF
        bg = np.where(active, bg_new, bg)
        fg = np.where(active[:, None], fg_new, fg)
    return post


def mask_batch(seq_list, lr: np.ndarray, x_index: int,
               min_mask_prob: float = 0.9, max_offset: int = 50):
    """Mask low-complexity residues (to X) in a list of numeric sequences.

    Returns (masked sequence list, total masked residues). Sequences are
    grouped into padded batches internally.
    """
    order = np.argsort([len(s) for s in seq_list], kind="stable")
    out = [None] * len(seq_list)
    total = 0
    # big batches: the t-loop in repeat_probs runs L_max times per batch,
    # so fewer/wider batches cut Python-loop iterations ~linearly
    B = 2048
    for lo in range(0, len(order), B):
        idxs = order[lo: lo + B]
        lens = np.array([len(seq_list[i]) for i in idxs])
        L = int(lens.max()) if len(lens) else 0
        if L == 0:
            for i in idxs:
                out[i] = seq_list[i].copy()
            continue
        batch = np.zeros((len(idxs), L), dtype=np.int64)
        for r, i in enumerate(idxs):
            batch[r, : lens[r]] = seq_list[i]
        post = repeat_probs(batch, lens, lr, max_offset)
        for r, i in enumerate(idxs):
            s = seq_list[i].copy()
            m = post[r, : lens[r]] >= np.float32(min_mask_prob)
            s[m] = x_index
            total += int(m.sum())
            out[i] = s
    return out, total
