"""Spaced k-mers and the CSR inverted k-mer index.

Reference semantics reproduced:
  - spaced seed patterns (hard-coded tables, src/commons/Sequence.h:20-75)
  - k-mer integer codec: little-endian, index = sum l_i * A^i with A = 20
    (X excluded; src/prefiltering/Indexer.cpp:4-21)
  - index build (src/prefiltering/IndexTable.h:135-424,
    IndexBuilder.cpp): masked target sequences, k-mers containing X skipped,
    k-mers with self-score < threshold skipped, one entry per (sequence,
    k-mer) at its smallest position, entry = (seqId, position_j), posting
    lists sorted by sequence id.

Layout: the index is two flat numpy arrays (CSR offsets + packed entries)
that can be uploaded to device memory and gathered by the device matcher;
the build is vectorized host numpy.
"""

import numpy as np

# spaced seed patterns from the reference (1 = informative position)
SPACED_PATTERNS = {
    4: [1, 1, 1, 0, 1],
    5: [1, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1],
    6: [1, 1, 0, 1, 0, 1, 0, 0, 1, 1],
    7: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1],
    8: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1],
    9: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1],
    10: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1],
    11: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1],
    12: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    13: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    14: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
    15: [1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1,
         1],
}


def pattern_offsets(kmer_size: int, spaced: bool = True,
                    user_pattern: str = ""):
    """Informative position offsets + total span of the seed pattern."""
    if user_pattern:
        pat = [1 if c == "1" else 0 for c in user_pattern]
        if sum(pat) != kmer_size:
            raise ValueError("user pattern weight != kmer size")
    elif spaced and kmer_size in SPACED_PATTERNS:
        pat = SPACED_PATTERNS[kmer_size]
    else:
        pat = [1] * kmer_size
    offsets = np.array([i for i, b in enumerate(pat) if b], dtype=np.int64)
    return offsets, len(pat)


def kmer_powers(alpha: int, k: int) -> np.ndarray:
    return (alpha ** np.arange(k)).astype(np.int64)


def extract_kmers(seq_num: np.ndarray, offsets: np.ndarray, span: int,
                  alpha: int, x_index: int):
    """All spaced k-mers of a sequence.

    Returns (indices int64, positions int64, has_x bool) — one row per
    starting position i in [0, L - span].
    """
    L = len(seq_num)
    n = L - span + 1
    if n <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    win = seq_num[np.arange(n)[:, None] + offsets[None, :]].astype(np.int64)
    has_x = (win == x_index).any(axis=1)
    powers = kmer_powers(alpha, len(offsets))
    idx = win @ powers
    pos = np.arange(n, dtype=np.int64)
    return idx, pos, has_x


class KmerIndexTable:
    """CSR inverted index: kmer -> [(local seqId, position u16), ...]."""

    def __init__(self, alpha: int, kmer_size: int, spaced: bool = True,
                 user_pattern: str = ""):
        self.alpha = alpha
        self.k = kmer_size
        self.offsets_pat, self.span = pattern_offsets(kmer_size, spaced,
                                                      user_pattern)
        self.table_size = alpha ** kmer_size
        self.offsets = None       # (table_size + 1,) int64
        self.entries_seq = None   # (n_entries,) int64 local seq id
        self.entries_pos = None   # (n_entries,) uint16 position
        self.masked_seqs = None   # list of masked numeric sequences

    def build(self, masked_seqs, x_index: int, kmer_thr: int,
              self_score: np.ndarray, chunk_windows: int = 1 << 22):
        """masked_seqs: list of masked numeric target sequences (local id
        order). self_score: per-letter diagonal score of the seed matrix.

        Vectorized across sequences: all windows of a chunk of sequences
        are extracted/filtered/deduplicated with flat numpy segment ops
        (the reference's per-sequence IndexBuilder loop, IndexBuilder.cpp,
        recast for a host that feeds a device-resident index)."""
        lens = np.array([len(s) for s in masked_seqs], dtype=np.int64)
        n_seqs = len(masked_seqs)
        nwin = np.maximum(lens - self.span + 1, 0)
        chunks_k, chunks_s, chunks_p = [], [], []
        lo = 0
        while lo < n_seqs:
            hi = lo + 1
            acc = int(nwin[lo])
            while hi < n_seqs and acc + nwin[hi] <= chunk_windows:
                acc += int(nwin[hi])
                hi += 1
            if acc == 0:
                lo = hi
                continue
            sub = masked_seqs[lo:hi]
            sub_n = nwin[lo:hi]
            cat = np.concatenate([s.astype(np.uint8) for s in sub])
            cat_off = np.concatenate(
                [[0], np.cumsum(lens[lo:hi])])[:-1]
            sid = np.repeat(np.arange(hi - lo, dtype=np.int64), sub_n)
            wfirst = np.concatenate([[0], np.cumsum(sub_n)])[:-1]
            pos_l = np.arange(acc, dtype=np.int64) - np.repeat(wfirst,
                                                               sub_n)
            gpos = cat_off[sid] + pos_l
            # stream per pattern position (never materialize the (W, k)
            # window matrix): code, X mask, self-score in k 1-D passes
            powers = kmer_powers(self.alpha, len(self.offsets_pat))
            idx = np.zeros(acc, dtype=np.int64)
            has_x = np.zeros(acc, dtype=bool)
            win_sc = (np.zeros(acc, dtype=np.int64) if kmer_thr > 0
                      else None)
            for i, off in enumerate(self.offsets_pat):
                letter = cat[gpos + off].astype(np.int64)
                idx += letter * powers[i]
                has_x |= letter == x_index
                if kmer_thr > 0:
                    win_sc += self_score[letter]
            keep = ~has_x
            if kmer_thr > 0:
                keep &= win_sc >= kmer_thr
            idx, sid, pos_l = idx[keep], sid[keep], pos_l[keep]
            # one entry per (seq, kmer): smallest position. Windows are
            # already ascending-position within each sequence, so a single
            # STABLE sort on the composite (sid, kmer) key keeps the first
            # occurrence = smallest position (reference sorts (kmer, pos)
            # and keeps the first).
            order = np.argsort(sid * self.table_size + idx, kind="stable")
            sid, idx, pos_l = sid[order], idx[order], pos_l[order]
            first = np.ones(len(idx), dtype=bool)
            first[1:] = (idx[1:] != idx[:-1]) | (sid[1:] != sid[:-1])
            chunks_k.append(idx[first])
            chunks_s.append(sid[first] + lo)
            chunks_p.append(pos_l[first])
            lo = hi
        if chunks_k:
            kmers = np.concatenate(chunks_k)
            seqs = np.concatenate(chunks_s)
            poss = np.concatenate(chunks_p)
        else:
            kmers = seqs = poss = np.zeros(0, dtype=np.int64)
        # CSR: stable sort by kmer preserves seq-id order within lists
        order = np.argsort(kmers, kind="stable")
        kmers, seqs, poss = kmers[order], seqs[order], poss[order]
        self.sparse = self.table_size > (1 << 26)
        if self.sparse:
            # 4^15-sized dense offsets would need GBs; store the sorted
            # unique k-mers + CSR offsets and binary-search lookups instead
            self.uniq_kmers, counts = (np.unique(kmers, return_counts=True)
                                       if len(kmers)
                                       else (np.zeros(0, np.int64),
                                             np.zeros(0, np.int64)))
            self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
                np.int64)
        else:
            counts = np.bincount(kmers, minlength=self.table_size) \
                if len(kmers) else np.zeros(self.table_size, dtype=np.int64)
            self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
                np.int64)
        self.entries_seq = seqs.astype(np.int64)
        self.entries_pos = poss.astype(np.uint16)
        self.masked_seqs = masked_seqs
        return self

    def lists(self, kmer_indices: np.ndarray):
        """Posting-list spans for a batch of kmer indices.

        Returns (starts, counts)."""
        if getattr(self, "sparse", False):
            kmer_indices = np.asarray(kmer_indices, dtype=np.int64)
            if len(self.uniq_kmers) == 0:
                z = np.zeros(len(kmer_indices), dtype=np.int64)
                return z, z.copy()
            if self.table_size <= (1 << 27):
                # the hot path does ~10k lookups/query: a dense i32
                # offsets array (<=512 MB at 2^27 slots) turns the
                # binary search into two gathers
                d = getattr(self, "_dense32", None)
                if d is None:
                    cnts = np.diff(self.offsets)
                    tmp = np.zeros(self.table_size, np.int64)
                    tmp[self.uniq_kmers] = cnts
                    d = np.zeros(self.table_size + 1, np.int32)
                    d[1:] = np.cumsum(tmp).astype(np.int32)
                    self._dense32 = d
                starts = d[kmer_indices].astype(np.int64)
                counts = d[kmer_indices + 1] - starts
                return starts, counts
            slot = np.searchsorted(self.uniq_kmers, kmer_indices)
            slot = np.minimum(slot, len(self.uniq_kmers) - 1)
            hit = self.uniq_kmers[slot] == kmer_indices
            starts = self.offsets[slot]
            counts = np.where(hit, self.offsets[slot + 1] - starts, 0)
            return starts, counts
        starts = self.offsets[kmer_indices]
        counts = self.offsets[kmer_indices + 1] - starts
        return starts, counts
