"""linclust k-min-mer candidate generation (Linclust v1, longest-center).

Reference: src/linclust/kmermatcher.cpp. Per sequence, the --kmer-per-seq
lowest-hashed k-mers (xxhash64 low 16 bits, seed --hash-shift) plus one
whole-sequence hash entry are collected; the global array is sorted by
(kmer, seqLen desc, id, pos); per k-mer group the longest sequence becomes
the center and center->member pairs with diagonals are emitted, deduplicated
by (center, member) keeping the most frequent diagonal, and written as a
prefilter-format DB keyed by center.

Reduced 13-letter alphabet (data/reduced.py), consecutive (non-spaced)
k-mers, k = max(10, log(residues)/log(8.7)).
"""

import numpy as np

P1 = np.uint64(11400714785074694791)
P2 = np.uint64(14029467366897019727)
P3 = np.uint64(1609587929392839161)
P4 = np.uint64(9650029242287828579)
P5 = np.uint64(2870177450012600261)


def _rotl(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def xxh64_u64(values: np.ndarray, seed: int) -> np.ndarray:
    """XXH64 of each 8-byte little-endian uint64 (vectorized)."""
    with np.errstate(over="ignore"):
        v = values.astype(np.uint64)
        h = np.uint64(seed) + P5 + np.uint64(8)
        k1 = v * P2
        k1 = _rotl(k1, 31)
        k1 = k1 * P1
        h = h ^ k1
        h = _rotl(h, 27) * P1 + P4
        h ^= h >> np.uint64(33)
        h *= P2
        h ^= h >> np.uint64(29)
        h *= P3
        h ^= h >> np.uint64(32)
    return h


_POW31 = np.ones(1, np.uint64)


def poly_hash(seq_num: np.ndarray) -> np.uint64:
    """Util::hash: h = h*31 + x (u64 wraparound), as one dot product with
    the powers of 31 mod 2^64: sum_i x_i * 31^(L-1-i), every product and
    sum wrapping mod 2^64 as the loop's do."""
    global _POW31
    n = len(seq_num)
    if n == 0:
        return np.uint64(0)
    if len(_POW31) < n:
        pw = np.full(max(n, 2 * len(_POW31)), 31, np.uint64)
        pw[0] = 1
        _POW31 = np.cumprod(pw, dtype=np.uint64)
    return (np.asarray(seq_num).astype(np.uint64)
            * _POW31[n - 1::-1]).sum(dtype=np.uint64)


def select_kmers(seq_num: np.ndarray, k: int, alpha: int, x_index: int,
                 kmer_considered: int, hash_shift: int,
                 offsets: np.ndarray = None, span: int = None):
    """Lowest-hash k-mer selection for one sequence.

    Returns (kmer u64 array, pos array, hash16 array) of the selected
    k-mers, in sequence order, reproducing the reference's histogram
    threshold + last-bin-excess admission (kmermatcher.cpp:240-340).
    offsets/span describe a spaced seed pattern (consecutive if omitted).
    """
    if offsets is None:
        offsets = np.arange(k)
        span = k
    L = len(seq_num)
    n = L - span + 1
    if n <= 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    win = seq_num[np.arange(n)[:, None] + offsets[None, :]]
    valid = ~(win == x_index).any(axis=1)
    powers = (np.uint64(alpha) ** np.arange(k, dtype=np.uint64))
    with np.errstate(over="ignore"):
        idx = (win.astype(np.uint64) * powers[None, :]).sum(
            axis=1, dtype=np.uint64)
    idx = idx[valid]
    pos = np.nonzero(valid)[0]
    if len(idx) == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    hashes = (xxh64_u64(idx, hash_shift) & np.uint64(0xFFFF)).astype(np.int64)
    target = min(kmer_considered, len(idx))
    # the reference's 65,536-bin histogram threshold: thr - 1 is the
    # smallest hash t with |{h <= t}| >= target, i.e. the target-th
    # smallest hash; in_bins = |{h <= thr - 1}|
    thr = int(np.partition(hashes, target - 1)[target - 1]) + 1
    in_bins = int((hashes < thr).sum())
    excess = in_bins - target
    lt = hashes < thr - 1
    eq = hashes == thr - 1
    if excess > 0:
        admit_eq = eq & (np.cumsum(eq) <= excess)
    else:
        admit_eq = eq
    admitted = lt | admit_eq
    admitted &= np.cumsum(admitted) <= target
    return idx[admitted], pos[admitted], hashes[admitted]




def _swap_center_by_weight(kmer, sid, pos, slen, weights, masked=None):
    """swapCenterSequence (kmermatcher.cpp:407-448): per k-mer group, swap
    the strictly-highest-weight entry to the group head so it becomes the
    representative."""
    group_key = masked if masked is not None else kmer
    n = len(kmer)
    start = 0
    while start < n:
        end = start + 1
        while end < n and group_key[end] == group_key[start]:
            end += 1
        best = start
        best_w = weights.get(int(sid[start]), 0.0)
        for i in range(start + 1, end):
            w = weights.get(int(sid[i]), 0.0)
            if w > best_w:
                best_w = w
                best = i
        if best != start:
            for arr in (kmer, sid, pos, slen):
                arr[start], arr[best] = arr[best].copy(), arr[start].copy()
        start = end


def build_pairs(seqs, keys, k: int, alpha: int, x_index: int,
                kmers_per_seq: int, kmers_per_seq_scale: float,
                hash_shift: int, cov_thr: float, cov_mode: int,
                include_only_extendable: bool, spaced: bool = False,
                weights=None, weight_thr: float = 0.9,
                hash_range=None):
    """Collect entries, group by kmer, emit center->member pairs.

    seqs: list of reduced numeric sequences in local id order; keys: db keys.
    Returns structured pair arrays (rep_key, member_key, diag i16, count later).
    """
    from ..align.util import can_be_covered
    from ..prefilter.kmer_index import pattern_offsets
    offsets, span = pattern_offsets(k, spaced)
    ks, ids, poss, lens = [], [], [], []
    lo, hi = hash_range if hash_range is not None else (0, 65535)
    for lid, seq in enumerate(seqs):
        L = len(seq)
        considered = int(kmers_per_seq - 1 + kmers_per_seq_scale * L)
        kmers, pos, hashes = select_kmers(seq, k, alpha, x_index,
                                          considered, hash_shift, offsets,
                                          span)
        if hash_range is not None:
            # split admission by hash range AFTER the per-sequence
            # threshold (fillKmerPositionArray hashStartRange gate)
            keep = (hashes >= lo) & (hashes <= hi)
            kmers, pos = kmers[keep], pos[keep]
        key = int(keys[lid])
        ks.append(kmers)
        ids.append(np.full(len(kmers), key, dtype=np.int64))
        poss.append(pos)
        lens.append(np.full(len(kmers), L, dtype=np.int64))
        # whole-sequence hash entry
        seq_hash = xxh64_u64(np.array([poly_hash(seq)], dtype=np.uint64),
                             hash_shift)[0]
        if hash_range is None or lo <= int(seq_hash) & 0xFFFF <= hi:
            ks.append(np.array([seq_hash], dtype=np.uint64))
            ids.append(np.array([key], dtype=np.int64))
            poss.append(np.array([0], dtype=np.int64))
            lens.append(np.array([L], dtype=np.int64))
    kmer = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
    sid = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    pos = np.concatenate(poss) if poss else np.zeros(0, np.int64)
    slen = np.concatenate(lens) if lens else np.zeros(0, np.int64)

    # sort by (kmer, seqLen desc, id, pos)
    order = np.lexsort((pos, sid, -slen, kmer))
    kmer, sid, pos, slen = kmer[order], sid[order], pos[order], slen[order]

    if weights is not None:
        _swap_center_by_weight(kmer, sid, pos, slen, weights)

    # group boundaries
    n = len(kmer)
    rep_k, mem_k, diags, mem_len = [], [], [], []
    start = 0
    while start < n:
        end = start + 1
        while end < n and kmer[end] == kmer[start]:
            end += 1
        if end - start >= 2:
            rep_id = sid[start]
            rep_pos = pos[start]
            rep_len = slen[start]
            # weighted linclust (SequenceWeights): members above the weight
            # threshold stay unclaimed so they can center their own cluster
            # (kmermatcher.cpp:537-545,743-746)
            skip_w = 0
            if weights is not None:
                skip_w = sum(1 for i in range(start + 1, end)
                             if weights.get(int(sid[i]), 0.0) > weight_thr)
                if (end - start) - skip_w <= 1:
                    start = end
                    continue
            for i in range(start, end):
                if (weights is not None and i > start
                        and weights.get(int(sid[i]), 0.0) > weight_thr):
                    continue
                diagonal = int(rep_pos) - int(pos[i])
                can_ext = diagonal < 0 or diagonal > int(rep_len - slen[i])
                covered = can_be_covered(cov_thr, cov_mode, float(rep_len),
                                         float(slen[i]))
                if (not include_only_extendable and covered) or \
                        (can_ext and include_only_extendable):
                    rep_k.append(int(rep_id))
                    mem_k.append(int(sid[i]))
                    diags.append(np.int16(diagonal))
                    mem_len.append(int(slen[i]))
        start = end
    return (np.array(rep_k, dtype=np.int64), np.array(mem_k, dtype=np.int64),
            np.array(diags, dtype=np.int16))


def write_result(writer, rep_k, mem_k, diags, revs=None):
    """Sort pairs by (rep, member, diag) and serialize per representative
    (kmermatcher.cpp writeKmerMatcherResult), including its write_sets quirk
    (once any rep wrote members, later member-less reps are still written).
    For nucleotide pairs `revs` flags reversed matches; their score is
    emitted negative (writeKmerMatcherResult bestReverMask)."""
    order = np.lexsort((diags, mem_k, rep_k))
    rep_k, mem_k, diags = rep_k[order], mem_k[order], diags[order]
    revs = revs[order] if revs is not None else None
    n = len(rep_k)
    i = 0
    write_sets = 0
    written = set()
    while i < n:
        rep = int(rep_k[i])
        j = i
        lines = [f"{rep}\t0\t0\n"]
        members_written = 0
        while j < n and rep_k[j] == rep:
            member = int(mem_k[j])
            # count run for this member; most frequent diagonal (>= latest)
            e = j
            best_diag = int(diags[j])
            best_rev = bool(revs[j]) if revs is not None else False
            max_cnt = 0
            cnt = 0
            prev = None
            top = 0
            # nucleotide quirk (writeKmerMatcherResult): the counting loop
            # requires kmer == repSeqId, which only reverse entries (bit 63
            # clear) satisfy — a forward first entry yields score 0 with its
            # own diagonal, and counting stops at the first forward entry
            while e < n and rep_k[e] == rep and mem_k[e] == member \
                    and (revs is None or revs[e]):
                d = int(diags[e])
                cnt = cnt + 1 if d == prev else 1
                if cnt >= max_cnt:
                    best_diag = d
                    max_cnt = cnt
                    if revs is not None:
                        best_rev = bool(revs[e])
                prev = d
                e += 1
                top += 1
            # skip the rest of the (rep, member) group (lastTargetId gate)
            while e < n and rep_k[e] == rep and mem_k[e] == member:
                e += 1
            if member != rep:
                score = -top if best_rev else top
                lines.append(f"{member}\t{score}\t{best_diag}\n")
                members_written += 1
            j = e
        write_sets += members_written
        if write_sets > 0:
            writer.write(rep, "".join(lines).encode())
            written.add(rep)
        i = j
    return written


# -- nucleotide (reverse-complement canonical) path -------------------------------

BIT63 = np.uint64(1) << np.uint64(63)


def rev_complement(idx: np.ndarray, k: int) -> np.ndarray:
    """Util::revComplement: reverse base order + complement of the
    big-endian 2-bit packed k-mer. In the ACTG alphabet order
    (NucleotideMatrix) the complement is XOR 2 (A0<->T2, C1<->G3)."""
    out = np.zeros_like(idx)
    x = idx.copy()
    two = np.uint64(2)
    three = np.uint64(3)
    for _ in range(k):
        out = (out << two) | ((x & three) ^ two)
        x = x >> two
    return out


def _admit(hashes: np.ndarray, target: int):
    """Histogram-threshold admission (kmermatcher.cpp:240-262)."""
    counts = np.bincount(hashes, minlength=65536)
    cum = np.cumsum(counts)
    thr = int(np.searchsorted(cum, target) + 1)
    in_bins = int(cum[thr - 1])
    excess = in_bins - target
    lt = hashes < thr - 1
    eq = hashes == thr - 1
    admit_eq = eq & (np.cumsum(eq) <= excess) if excess > 0 else eq
    admitted = lt | admit_eq
    admitted &= np.cumsum(admitted) <= target
    return admitted


def adjusted_kmer_lengths(win: np.ndarray, k: int):
    """MarkovKmerScore::adjustedLength per window (vectorized): stop the
    5-mer score accumulation at (k - ORDER) * MEDIAN_SCORE
    (kmermatcher.cpp:179-193)."""
    from ..data.markov_scores import (MARKOV5_SCORES, MARKOV_ORDER,
                                      MEDIAN_SCORE)
    scores = np.asarray(MARKOV5_SCORES, np.float32)
    n, kw = win.shape
    thr = (k - MARKOV_ORDER) * MEDIAN_SCORE   # threshold from the BASE k
    shifts = (np.uint64(2) * np.arange(MARKOV_ORDER, -1, -1,
                                       dtype=np.uint64))
    lens = np.full(n, MARKOV_ORDER, np.int64)
    total = np.zeros(n, np.float32)
    active = np.ones(n, bool)
    for pos in range(kw - MARKOV_ORDER):
        sub = win[:, pos:pos + MARKOV_ORDER + 1].astype(np.uint64)
        idx = ((sub & np.uint64(3)) << shifts[None, :]).sum(
            axis=1, dtype=np.uint64)
        step = active & (total < thr)
        total = np.where(step, total + scores[idx.astype(np.int64)], total)
        lens = np.where(step, pos + 1 + MARKOV_ORDER, lens)
        active &= step
    return lens


def select_kmers_nucl(seq_num: np.ndarray, k: int, kmer_considered: int,
                      hash_shift: int, adjust_len: bool = False):
    """Canonical (min of fwd/revcomp) 2-bit k-mers of one nucleotide
    sequence; returns (kmer-with-bit63-flag u64, effective pos, hash16).
    Forward picks carry bit 63 SET, reverse picks cleared; palindromic
    k-mers are skipped (kmermatcher.cpp:166-203). With --adjust-kmer-len
    the enumeration window extends to min(k+5, 23) characters and each
    k-mer is truncated/extended to the Markov score threshold
    (kmermatcher.cpp:115,179-200)."""
    span = min(k + 5, 23) if adjust_len else k
    L = len(seq_num)
    n = L - span + 1
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.int64),
             np.zeros(0, np.int64))
    if n <= 0:
        return empty
    win = seq_num[np.arange(n)[:, None] + np.arange(span)[None, :]]
    valid = (win < 4).all(axis=1)
    shifts = (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64))
    with np.errstate(over="ignore"):
        idx = ((win[:, :k].astype(np.uint64) & np.uint64(3))
               << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    pos = np.nonzero(valid)[0]
    idx = idx[valid]
    win = win[valid]
    if len(idx) == 0:
        return empty
    rc = rev_complement(idx, k)
    keep = rc != idx                      # skip palindromes
    idx, rc, pos, win = idx[keep], rc[keep], pos[keep], win[keep]
    if len(idx) == 0:
        return empty
    pick_rev = rc < idx
    canon = np.where(pick_rev, rc, idx)
    hashes = (xxh64_u64(canon, hash_shift)
              & np.uint64(0xFFFF)).astype(np.int64)
    if adjust_len:
        # oriented full-window characters: reverse-complement for reverse
        # picks (ACTG alphabet: complement = XOR 2)
        oriented = np.where(pick_rev[:, None],
                            win[:, ::-1].astype(np.uint8) ^ np.uint8(2),
                            win.astype(np.uint8))
        lens = adjusted_kmer_lengths(oriented, k)
        # pack the first `len` characters big-endian per row
        kmer_val = np.zeros(len(canon), np.uint64)
        with np.errstate(over="ignore"):
            for j in range(span):
                active = lens > j
                kmer_val = np.where(
                    active,
                    (kmer_val << np.uint64(2))
                    | (oriented[:, j].astype(np.uint64) & np.uint64(3)),
                    kmer_val)
        eff_pos = np.where(pick_rev, L - pos - lens, pos)
        flagged = np.where(pick_rev, kmer_val, kmer_val | BIT63)
    else:
        eff_pos = np.where(pick_rev, L - pos - k, pos)
        flagged = np.where(pick_rev, canon, canon | BIT63)
    admitted = _admit(hashes, min(kmer_considered, len(canon)))
    return flagged[admitted], eff_pos[admitted], hashes[admitted]


def build_pairs_nucl(seqs, keys, k: int, kmers_per_seq: int,
                     kmers_per_seq_scale: float, hash_shift: int,
                     cov_thr: float, cov_mode: int,
                     include_only_extendable: bool,
                     adjust_len: bool = False):
    """Nucleotide center->member pairs with orientation handling
    (kmermatcher.cpp:495-665). Returns (rep_k, mem_k, diag i16, rev)."""
    from ..align.util import can_be_covered
    ks, ids, poss, lens = [], [], [], []
    for lid, seq in enumerate(seqs):
        L = len(seq)
        considered = int(kmers_per_seq - 1 + kmers_per_seq_scale * L)
        kmers, pos, _ = select_kmers_nucl(seq, k, considered, hash_shift,
                                          adjust_len)
        key = int(keys[lid])
        ks.append(kmers)
        ids.append(np.full(len(kmers), key, dtype=np.int64))
        poss.append(pos)
        lens.append(np.full(len(kmers), L, dtype=np.int64))
        ks.append(np.array([xxh64_u64(np.array([poly_hash(seq)],
                                               dtype=np.uint64),
                                      hash_shift)[0]], dtype=np.uint64))
        ids.append(np.array([key], dtype=np.int64))
        poss.append(np.array([0], dtype=np.int64))
        lens.append(np.array([L], dtype=np.int64))
    kmer = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
    sid = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    pos = np.concatenate(poss) if poss else np.zeros(0, np.int64)
    slen = np.concatenate(lens) if lens else np.zeros(0, np.int64)

    masked = kmer | BIT63
    order = np.lexsort((pos, sid, -slen, masked))
    kmer, sid, pos, slen = kmer[order], sid[order], pos[order], slen[order]
    masked = masked[order]
    is_rev = (kmer & BIT63) == 0

    n = len(kmer)
    rep_k, mem_k, diags, revs = [], [], [], []
    start = 0
    while start < n:
        end = start + 1
        while end < n and masked[end] == masked[start]:
            end += 1
        if end - start >= 2:
            rep_id = sid[start]
            rep_pos = int(pos[start])
            rep_len = int(slen[start])
            rep_rev = bool(is_rev[start])
            for i in range(start, end):
                t_rev = bool(is_rev[i])
                t_len = int(slen[i])
                if rep_rev != t_rev:
                    q_pos = (rep_len - 1) - rep_pos if not rep_rev \
                        else rep_pos
                    t_pos = (t_len - 1) - int(pos[i]) if not rep_rev \
                        else int(pos[i])
                    q_needs_rev = True
                elif rep_rev:           # both reverse
                    q_pos = (rep_len - 1) - rep_pos
                    t_pos = (t_len - 1) - int(pos[i])
                    q_needs_rev = False
                else:                   # both forward
                    q_pos = rep_pos
                    t_pos = int(pos[i])
                    q_needs_rev = False
                diagonal = q_pos - t_pos
                can_ext = diagonal < 0 or diagonal > (rep_len - t_len)
                covered = can_be_covered(cov_thr, cov_mode,
                                         float(rep_len), float(t_len))
                if (not include_only_extendable and covered) or \
                        (can_ext and include_only_extendable):
                    rep_k.append(int(rep_id))
                    mem_k.append(int(sid[i]))
                    diags.append(np.int16(diagonal))
                    revs.append(q_needs_rev)
        start = end
    return (np.array(rep_k, dtype=np.int64),
            np.array(mem_k, dtype=np.int64),
            np.array(diags, dtype=np.int16),
            np.array(revs, dtype=bool))
