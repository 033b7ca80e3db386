"""Linclust v2 kmermatcher: adjacency / count-table center-swapping chain.

Reference: src/linclust/kmermatcher.cpp. With --include-adjacency or
--include-count-table (both default on, kmermatcher.cpp:1501-1507) the
command switches to the write-buffer dataflow: the k-mer entry array is
extracted once (with 6 adjacent residues per entry, :332-380), sorted by
(kmer, seqLen desc, id, pos), and then a CHAIN of assignGroup iterations
runs over that same array — 1 longest-center pass, --num-adjacency
adjacency passes and --num-count-table count-table passes (:1040-1070).
Each pass re-picks a group center (phase 1, :534-598): adjacency mode
scores every member's 6-residue context against the current center's
context rows of the reduced substitution matrix and swaps the MINIMUM
scorer to the front (marking the previous center's records with an
adjacency-0 byte of 0xFF so later passes skip them); count-table mode
swaps the member with the highest global match count to the front. The
swaps and markings persist in the entry array across iterations, so each
pass explores a different center. Every pass emits its own full pair
stream (writeKmersToDisk, :1907-2030: per (rep,member,diagonal) run with
a uint8 run-length score); the streams are k-way merged at the end
(mergeKmerFilesAndOutput, :1711-1906: per (rep,member) the diagonal with
the highest summed run-length wins, later diagonal on ties, prefScore =
total summed run-length over all diagonals).

The count table itself is filled by a setup pass (setupCountTable,
:1112-1174): a hash-bucket histogram over every selected k-mer's 16-bit
hash picks the lowest-hash range holding --count-table-scale (0.1) of the
estimated total k-mers, and a longest-center group scan over only that
range counts, per sequence, how often it appears as a group member.
"""

import numpy as np

from ..align.util import can_be_covered
from . import kmermatcher as km

MAXK = np.uint64(0xFFFFFFFFFFFFFFFF)
COV_MODE_TARGET = 2
ADJ_INVALID = 255


def build_entries(seqs, keys, k, alpha, x_idx, kmer_per_seq, scale,
                  hash_shift, offsets, span, with_adj):
    """Extract per-sequence k-min-mer entries + whole-sequence hash entry.

    Returns dict of arrays: kmer u64, id i64, pos i64, h16 i64 (16-bit
    hash for count-table bucketing), len i64, adj u8[N,6] (or None).
    fillKmerPositionArray (kmermatcher.cpp:82-404); the whole-sequence
    hash entry is buffered before the selected k-mers (:255-276).
    """
    ks, ids, poss, h16s, lens, adjs = [], [], [], [], [], []
    for lid, seq in enumerate(seqs):
        L = len(seq)
        key = int(keys[lid])
        # whole-sequence identity entry (adjacency bytes all X)
        seq_hash = km.xxh64_u64(
            np.array([km.poly_hash(seq)], dtype=np.uint64), hash_shift)[0]
        ks.append(np.array([seq_hash], dtype=np.uint64))
        ids.append(np.array([key], dtype=np.int64))
        poss.append(np.array([0], dtype=np.int64))
        h16s.append(np.array([int(seq_hash) & 0xFFFF], dtype=np.int64))
        lens.append(np.array([L], dtype=np.int64))
        if with_adj:
            adjs.append(np.full((1, 6), x_idx, dtype=np.uint8))

        considered = int(kmer_per_seq - 1 + scale * L)
        kmers, pos, hsh = km.select_kmers(seq, k, alpha, x_idx, considered,
                                          hash_shift, offsets, span)
        n = len(kmers)
        ks.append(kmers)
        ids.append(np.full(n, key, dtype=np.int64))
        poss.append(pos)
        h16s.append(hsh)
        lens.append(np.full(n, L, dtype=np.int64))
        if with_adj:
            # the 3 residues before the k-mer start and the 3 after its end
            # (:332-360), X where they fall outside the sequence: gathered
            # from the sequence padded with 3 X on each side
            pad = np.full(L + 6, x_idx, dtype=np.uint8)
            pad[3:L + 3] = seq
            cols = np.array([0, 1, 2, span + 3, span + 4, span + 5])
            adjs.append(pad[np.asarray(pos, np.int64)[:, None] + cols])
    kmer = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
    n = len(kmer)
    return {
        "kmer": np.concatenate([kmer, np.array([MAXK])]),
        "id": np.concatenate(ids + [np.zeros(1, np.int64)]) if ids
        else np.zeros(1, np.int64),
        "pos": np.concatenate(poss + [np.zeros(1, np.int64)]) if poss
        else np.zeros(1, np.int64),
        "h16": np.concatenate(h16s) if h16s else np.zeros(0, np.int64),
        "len": np.concatenate(lens + [np.zeros(1, np.int64)]) if lens
        else np.zeros(1, np.int64),
        "adj": (np.concatenate(adjs + [np.zeros((1, 6), np.uint8)])
                if with_adj else None),
        "n": n,
    }


def sort_entries(E):
    """Initial sort: (kmer, seqLen desc, id, pos) —
    KmerPosition::compareRepSequenceAndIdAndPos (kmermatcher.h:120-137)."""
    n = E["n"]
    order = np.lexsort((E["pos"][:n], E["id"][:n], -E["len"][:n],
                        E["kmer"][:n]))
    for f in ("kmer", "id", "pos", "len"):
        E[f][:n] = E[f][:n][order]
    if E["adj"] is not None:
        E["adj"][:n] = E["adj"][:n][order]


def compute_total_kmers(lens, k, kmer_per_seq, scale):
    """computeKmerCount (kmermatcher.cpp:1095-1103)."""
    total = 0
    for L in lens:
        adj_len = max(1, L - k + 2)
        total += min(adj_len, int(kmer_per_seq + scale * L))
    return total


def count_table_hash_cutoff(h16, total_kmers, count_scale):
    """setupCountTable hash-range selection (kmermatcher.cpp:1150-1169):
    the lowest hash buckets holding count_scale of the estimated k-mers.
    Returns inclusive upper hash bound, or None if every bucket fits."""
    hist = np.bincount(h16, minlength=65536)
    target = total_kmers * count_scale
    cum = 0
    for i in range(65536):
        if cum + hist[i] >= target:
            return i - 1
        cum += hist[i]
    return None


def assign_iteration(E, mode, counts, red_scores, cov_thr, cov_mode,
                     only_ext, adj_compiled, count_into=None):
    """One assignGroup pass over the (sorted) entry array, single thread.

    mode: 'default' | 'adj' | 'count' (AssignGroupFeature). Mutates E
    in place (phase-1 swaps + 0xFF adjacency-0 markings persist across
    iterations). Returns pair arrays (rep, member, diag) unless
    count_into is given (SetupCountTable phase: increments counts and
    returns None). Reference: assignGroup (kmermatcher.cpp:462-786).
    """
    # the loop runs on Python lists (numpy scalar access is the slow part
    # of this pass) and writes them back into E when it ends
    arrays = (E["kmer"], E["id"], E["pos"], E["len"])
    karr, iarr, parr, larr = (a.tolist() for a in arrays)
    adj = E["adj"]
    n = E["n"]
    len_of = dict(zip(iarr[:n], larr[:n]))
    maxk = int(MAXK)

    out_rep, out_mem, out_diag = [], [], []

    def swap(a, b):
        for arr in (karr, iarr, parr, larr):
            tmp = arr[a]
            arr[a] = arr[b]
            arr[b] = tmp
        if adj is not None:
            adj[[a, b]] = adj[[b, a]]

    s = 0
    prev_hash = karr[0]
    rep_key = int(iarr[0])
    sub_pos = (adj[0].copy() if mode == "adj" and adj is not None
               and adj[0, 0] != ADJ_INVALID else None)
    prev_set = 0
    e = 0
    while e <= n:
        curr = karr[e]
        if prev_hash != curr:
            # ---- phase 1: pick + swap in the center for this mode ----
            if mode == "adj" and sub_pos is not None:
                best, min_sc = s, None
                for i in range(s, e):
                    if karr[i] == maxk:
                        continue
                    if int(iarr[i]) == rep_key:
                        adj[i, 0] = ADJ_INVALID
                    if adj[i, 0] != ADJ_INVALID:
                        sc = 0
                        for j in range(6):
                            sc += int(red_scores[sub_pos[j], adj[i, j]])
                        if min_sc is None or sc <= min_sc:
                            min_sc, best = sc, i
                if best != s and karr[best] != maxk and \
                        adj[best, 0] != ADJ_INVALID:
                    swap(s, best)
            elif mode == "count":
                best, max_cnt = s, -1
                for i in range(s + 1, e):
                    if karr[i] == maxk:
                        continue
                    mid = int(iarr[i])
                    if mid != rep_key:
                        cnt = int(counts[mid])
                        if cnt >= max_cnt and (not adj_compiled
                                               or adj[i, 0] != ADJ_INVALID):
                            max_cnt, best = cnt, i
                if best != s and karr[best] != maxk and \
                        (not adj_compiled or adj[best, 0] != ADJ_INVALID):
                    swap(s, best)
            # ---- phase 2: emit pairs for the (possibly re-centered) group
            rep_key = int(iarr[s])
            rep_id = rep_key
            q_len = len_of[rep_key]
            rep_pos = int(parr[s])
            skip = mode == "adj" and adj[s, 0] == ADJ_INVALID
            if not skip:
                for i in range(s, e):
                    if karr[i] == maxk or prev_set == 1:
                        continue
                    mid = int(iarr[i])
                    # int diagonal, truncated to T (short) only at store
                    diagonal = rep_pos - int(parr[i])
                    t_len = len_of[mid]
                    can_ext = diagonal < 0 or diagonal > (q_len - t_len)
                    can_cov = can_be_covered(cov_thr, cov_mode,
                                             float(q_len), float(t_len))
                    if (not only_ext and can_cov) or (can_ext and only_ext):
                        if count_into is not None:
                            count_into[mid] += np.int16(1)
                        elif q_len < t_len and cov_mode == COV_MODE_TARGET:
                            out_rep.append(mid)
                            out_diag.append(int(np.int16(-diagonal)))
                            out_mem.append(rep_id)
                        else:
                            out_rep.append(rep_id)
                            out_diag.append(int(np.int16(diagonal)))
                            out_mem.append(mid)
            if e == n or karr[e] == maxk:
                break
            prev_set = 0
            prev_hash = curr
            s = e
            rep_key = int(iarr[e])
            sub_pos = (adj[s].copy() if mode == "adj" and adj is not None
                       and adj[s, 0] != ADJ_INVALID else None)
        if karr[e] == maxk:
            break
        prev_set += 1
        e += 1
    for a, values in zip(arrays, (karr, iarr, parr, larr)):
        a[:] = np.array(values, dtype=a.dtype)
    if count_into is not None:
        return None
    return (np.array(out_rep, dtype=np.int64),
            np.array(out_mem, dtype=np.int64),
            np.array(out_diag, dtype=np.int64))


def stream_from_pairs(rep, mem, diag):
    """Sort pairs by (rep, member, diag) and collapse runs of identical
    triples into one record with a uint8 run-length score
    (writeKmersToDisk, kmermatcher.cpp:1907-2030). Returns
    (rep, mem, diag, score_u8) arrays."""
    if len(rep) == 0:
        return (np.zeros(0, np.int64),) * 3 + (np.zeros(0, np.int64),)
    order = np.lexsort((diag, mem, rep))
    rep, mem, diag = rep[order], mem[order], diag[order]
    # run boundaries of identical (rep, mem, diag)
    new = np.ones(len(rep), dtype=bool)
    new[1:] = ((rep[1:] != rep[:-1]) | (mem[1:] != mem[:-1])
               | (diag[1:] != diag[:-1]))
    starts = np.nonzero(new)[0]
    ends = np.append(starts[1:], len(rep))
    runlen = (ends - starts) & 0xFF          # unsigned char score
    return rep[starts], mem[starts], diag[starts], runlen.astype(np.int64)


def merge_streams(streams):
    """K-way merge of the per-iteration pair streams
    (mergeKmerFilesAndOutput, kmermatcher.cpp:1711-1906). For every
    (rep, member): per-diagonal summed run-length decides the diagonal
    (later/larger diagonal wins ties); prefScore = total summed
    run-length; self-hits (member == rep) are skipped. Returns
    {rep: [(member, score, diagonal), ...]} with members ascending."""
    if not streams:
        return {}
    rep = np.concatenate([s[0] for s in streams])
    mem = np.concatenate([s[1] for s in streams])
    diag = np.concatenate([s[2] for s in streams])
    score = np.concatenate([s[3] for s in streams])
    result = {}
    if len(rep) == 0:
        return result
    order = np.lexsort((diag, mem, rep))
    rep, mem, diag, score = rep[order], mem[order], diag[order], score[order]
    i, n = 0, len(rep)
    while i < n:
        r = rep[i]
        hits = []
        j = i
        while j < n and rep[j] == r:
            m = mem[j]
            top = 0
            best_cnt = 0
            best_diag = 0
            k_ = j
            while k_ < n and rep[k_] == r and mem[k_] == m:
                d = diag[k_]
                dsum = 0
                while k_ < n and rep[k_] == r and mem[k_] == m \
                        and diag[k_] == d:
                    dsum += int(score[k_])
                    k_ += 1
                top += dsum
                if dsum >= best_cnt:
                    best_cnt = dsum
                    best_diag = int(d)
            if m != r:
                hits.append((int(m), top, best_diag))
            j = k_
        result[int(r)] = hits
        i = j
    return result


def kmermatcher_v2(seqs, keys, k, alpha, x_idx, kmer_per_seq, scale,
                   hash_shift, offsets, span, cov_thr, cov_mode, only_ext,
                   red_scores, include_adj=True, include_ct=True,
                   adj_iters=3, ct_iters=2, count_scale=0.1,
                   max_key=None):
    """Full linclust-v2 kmermatcher dataflow (amino-acid path).

    Returns {rep: [(member, score, diagonal), ...]}."""
    E = build_entries(seqs, keys, k, alpha, x_idx, kmer_per_seq, scale,
                      hash_shift, offsets, span, with_adj=include_adj)
    counts = None
    if include_ct:
        if max_key is None:
            max_key = int(max(keys)) if len(keys) else 0
        counts = np.zeros(max_key + 1, dtype=np.int16)
        lens = [len(s) for s in seqs]
        total = compute_total_kmers(lens, k, kmer_per_seq, scale)
        cutoff = count_table_hash_cutoff(E["h16"], total, count_scale)
        if cutoff is None or cutoff >= 0:
            CE = build_entries(seqs, keys, k, alpha, x_idx, kmer_per_seq,
                               scale, hash_shift, offsets, span,
                               with_adj=False)
            if cutoff is not None:
                keep = np.nonzero(CE["h16"] <= cutoff)[0]
                nk = len(keep)
                for f in ("kmer", "id", "pos", "len"):
                    CE[f] = np.concatenate([CE[f][:CE["n"]][keep],
                                            CE[f][CE["n"]:CE["n"] + 1]])
                CE["h16"] = CE["h16"][keep]
                CE["n"] = nk
            sort_entries(CE)
            assign_iteration(CE, "default", None, None, cov_thr, cov_mode,
                             only_ext, adj_compiled=False, count_into=counts)

    sort_entries(E)
    streams = [stream_from_pairs(*assign_iteration(
        E, "default", counts, red_scores, cov_thr, cov_mode, only_ext,
        adj_compiled=include_adj))]
    if include_adj:
        for _ in range(adj_iters):
            streams.append(stream_from_pairs(*assign_iteration(
                E, "adj", counts, red_scores, cov_thr, cov_mode, only_ext,
                adj_compiled=True)))
    if include_ct:
        for _ in range(ct_iters):
            streams.append(stream_from_pairs(*assign_iteration(
                E, "count", counts, red_scores, cov_thr, cov_mode, only_ext,
                adj_compiled=include_adj)))
    return merge_streams(streams)
