"""Out-of-core target-split prefilter merge.

A copy of mmseqs2_tpu/prefilter/split_merge.py (host numpy; it imports the
port's query_matcher).

Reference: Prefiltering's target-split mode builds the index per split and
merges per-query hit fragments (Prefiltering.cpp:287-310 split sizing,
mergeTargetSplits :412-598). The reference merges *truncated* per-split hit
lists, so its split output depends on the split count; we instead merge the
per-(query,id) candidate lists BEFORE thresholding, which makes split
output byte-identical to the unsplit run (and to the host oracle).

`finalize_query` reproduces QueryMatcher.match()'s tail exactly
(QueryMatcher.cpp:147-241 + getResult :401-458): per-query histogram,
adaptive threshold, score-desc stable ordering, identity pinning,
saturated-hit exact rescoring, and the rescoreHits truncation/rescale path.
"""

import numpy as np

from .query_matcher import (SCORE_RANGE, UCHAR_MAX, USHRT_MAX,
                            compute_score_threshold)


def self_ungapped_score(prof: np.ndarray, q_num: np.ndarray) -> int:
    """Best ungapped self-alignment on diagonal 0 (QueryMatcher.rescoreHits);
    vectorized max-subarray via cumsum/min-prefix."""
    s = prof[np.arange(len(q_num)), q_num].astype(np.int64)
    cums = np.cumsum(s)
    minpre = np.minimum(0, np.concatenate(
        [[0], np.minimum.accumulate(cums)[:-1]]))
    return int(max(0, (cums - minpre).max())) if len(s) else 0


def finalize_query(ids, diags, counts, max_hits, min_diag_thr,
                   identity_id, exact_fn, self_score):
    """ids/diags/counts: merged per-(id) best candidates, id-ascending
    (splits own disjoint ascending id ranges, so concatenation in split
    order is id-sorted). exact_fn(ids, diags) -> uncapped rescored scores.
    Returns the hit-tuple list like QueryMatcher.match."""
    ids = np.asarray(ids, np.int64)
    diags = np.asarray(diags, np.uint16)
    counts = np.asarray(counts, np.int64)

    score_sizes = np.bincount(counts, minlength=SCORE_RANGE) \
        if len(counts) else np.zeros(SCORE_RANGE, dtype=np.int64)
    diagonal_thr = compute_score_threshold(score_sizes, max_hits)
    diagonal_thr = max(min_diag_thr, diagonal_thr)

    keep = counts >= diagonal_thr
    ids, diags, counts = ids[keep], diags[keep], counts[keep]
    order = np.argsort(-counts, kind="stable")
    ids, diags, counts = ids[order], diags[order], counts[order]

    rescale = 0
    if diagonal_thr >= UCHAR_MAX:
        sat = counts >= UCHAR_MAX
        ids, diags = ids[sat], diags[sat]
        exact = exact_fn(ids, diags)
        rescale = max(1, min(self_score - UCHAR_MAX, USHRT_MAX))
        newc = np.minimum(np.maximum(exact - UCHAR_MAX, 0), USHRT_MAX)
        counts = ((newc.astype(np.float32) / np.float32(rescale)
                   * np.float32(UCHAR_MAX) + np.float32(0.5))
                  .astype(np.int64)) & 0xFF
        order = np.argsort(-counts, kind="stable")
        ids, diags, counts = ids[order], diags[order], counts[order]

    hits = []
    if identity_id >= 0:
        hits.append((identity_id, USHRT_MAX, 0))
    # exact scores for saturated survivors, batched
    need_exact = (counts >= UCHAR_MAX) if rescale == 0 else \
        np.zeros(len(counts), bool)
    exacts = {}
    if need_exact.any():
        ex = exact_fn(ids[need_exact], diags[need_exact])
        for j, i in enumerate(np.nonzero(need_exact)[0]):
            exacts[i] = int(ex[j])
    for i in range(len(ids)):
        if len(hits) >= max_hits:
            break
        tid = int(ids[i])
        sc = int(counts[i])
        if identity_id >= 0 and tid == identity_id:
            continue
        if sc < (0 if rescale else diagonal_thr):
            continue
        if rescale != 0:
            score = UCHAR_MAX + sc * rescale // 255
        elif sc >= UCHAR_MAX:
            score = exacts[i]
        else:
            score = sc
        hits.append((tid, score, int(np.int16(diags[i]))))
    start = 1 if identity_id >= 0 else 0
    tail = sorted(hits[start:], key=lambda h: (-abs(h[1]), h[0]))
    return hits[:start] + tail
