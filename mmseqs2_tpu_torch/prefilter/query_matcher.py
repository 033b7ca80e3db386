"""Per-query k-mer matching: posting-list gathering, double-diagonal
detection, ungapped diagonal rescoring, adaptive thresholding.

Reference: src/prefiltering/QueryMatcher.cpp (match :243-376, matchQuery
:103-241, getResult :401-458), CacheFriendlyOperations.cpp (findDuplicates
:38-180 — including the zeroed-byte-array quirk that makes a first match on
u8-diagonal 0 count as a double match), UngappedAlignment.cpp (diagonal
window + min(score,255) cap).

This is the numpy host implementation that defines the exact semantics; the
device (JAX) path batches the diagonal rescoring and will subsume the gather
stage (see prefilter/device.py).
"""

from dataclasses import dataclass

import numpy as np

from ..ops.encode import calc_local_aa_bias
from .kmer_index import extract_kmers

SCORE_RANGE = 256
USHRT_MAX = 65535
UCHAR_MAX = 255


@dataclass
class MatchStats:
    kmers_per_pos: float = 0.0
    db_matches: int = 0
    double_matches: int = 0


def compute_score_threshold(score_sizes: np.ndarray, max_hits: int) -> int:
    """QueryMatcher::computeScoreThreshold (QueryMatcher.h:211-221)."""
    found = 0
    thr = 0
    for s in range(SCORE_RANGE - 1, 0, -1):
        found += int(score_sizes[s])
        thr = s
        if found >= max_hits:
            return thr
    return 0


class QueryMatcher:
    def __init__(self, index_table, seed_submat, ungapped_submat,
                 kmer_thr: int, kmer_size: int, max_hits: int,
                 aa_bias_corr: bool = True, bias_scale: float = 1.0,
                 min_diag_score_thr: int = 15, generator=None,
                 take_only_best_kmer: bool = False,
                 is_nucleotide: bool = False):
        self.index = index_table
        self.seed = seed_submat
        self.ungapped = ungapped_submat
        self.kmer_thr = kmer_thr
        self.k = kmer_size
        self.max_hits = max_hits
        self.aa_bias_corr = aa_bias_corr
        self.bias_scale = bias_scale
        self.min_diag_thr = min_diag_score_thr
        self.generator = generator
        self.take_only_best = take_only_best_kmer
        self.is_nucleotide = is_nucleotide
        self.x_index = seed_submat.alphabet_size - 1
        self.stats = MatchStats()
        # concatenated masked target array for diagonal rescoring
        seqs = index_table.masked_seqs
        if hasattr(seqs, "cat"):          # index_io.CatSeqs packed layout
            self.t_lens = seqs.lens.astype(np.int64)
            self.t_offsets = seqs.offs.astype(np.int64)
            self.t_cat = seqs.cat.astype(np.int64)
        else:
            self.t_lens = np.array([len(s) for s in seqs], dtype=np.int64)
            self.t_offsets = np.concatenate(
                [[0], np.cumsum(self.t_lens)]).astype(np.int64)
            self.t_cat = (np.concatenate(seqs) if len(seqs) else
                          np.zeros(0, dtype=np.uint8)).astype(np.int64)

    # -- stage 1: k-mer match + double-diagonal detection ---------------------

    def gather_hits(self, q_num: np.ndarray, comp_bias: np.ndarray,
                    generator=None):
        """Collect (local target id, diagonal u16) double-match candidates in
        reference scan order: window by window (QueryMatcher.cpp:255-284),
        each window's similar k-mers in the generator's order, each k-mer's
        postings in index order. The windows are enumerated in one batch
        (KmerGenerator.generate_all, the concatenation of the per-window
        enumerations) and their postings expanded at once. `generator`
        (a profile query's) stands in for the matcher's own."""
        idx_all, pos_all, has_x = extract_kmers(
            q_num, self.index.offsets_pat, self.index.span,
            self.index.alpha, self.x_index)
        pos = pos_all[~has_x]
        if self.take_only_best:
            codes, win_of = idx_all[~has_x], np.arange(len(pos))
        elif len(pos):
            cols = pos[:, None] + self.index.offsets_pat[None, :]
            bias_f = comp_bias[cols].sum(axis=1)
            bias = np.trunc(np.where(bias_f < 0.0, bias_f - 0.5,
                                     bias_f + 0.5)).astype(np.int64)
            thr = np.maximum(self.kmer_thr - bias, 0)
            gen = generator if generator is not None else self.generator
            codes, win_of = gen.generate_all(
                q_num[cols].astype(np.int64), thr, pos)
        else:
            codes = win_of = np.zeros(0, np.int64)
        self.stats.kmers_per_pos = len(codes) / max(len(q_num), 1)
        starts, counts = self.index.lists(codes)
        counts = np.asarray(counts, np.int64)
        total = int(counts.sum())
        self.stats.db_matches = total
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint16))
        rep = np.repeat(np.arange(len(counts)), counts)
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        ent = np.asarray(starts, np.int64)[rep] + offs
        ids = self.index.entries_seq[ent]
        t_pos = self.index.entries_pos[ent].astype(np.int64)
        q_pos = pos[win_of][rep]
        diags = (q_pos.astype(np.uint16)
                 - t_pos.astype(np.uint16)).astype(np.uint16)  # u16 wrap
        return ids, diags

    @staticmethod
    def find_duplicates_counted(ids: np.ndarray, diags: np.ndarray):
        """findDuplicates with computeTotalScore=true (diagonalScoring off):
        one output per id with count = min(255, #duplicates) and the FIRST
        duplicate's diagonal."""
        if len(ids) == 0:
            return ids, diags, np.zeros(0, np.int64)
        order = np.argsort(ids, kind="stable")
        sid = ids[order]
        sdiag = diags[order]
        d8 = sdiag.astype(np.uint8)
        first_of_id = np.ones(len(sid), dtype=bool)
        first_of_id[1:] = sid[1:] != sid[:-1]
        prev_d8 = np.empty_like(d8)
        prev_d8[0] = 0
        prev_d8[1:] = d8[:-1]
        dup = np.where(first_of_id, d8 == 0, d8 == prev_d8)
        did, dd = sid[dup], sdiag[dup]
        if len(did) == 0:
            return did, dd, np.zeros(0, np.int64)
        first = np.ones(len(did), dtype=bool)
        first[1:] = did[1:] != did[:-1]
        starts = np.nonzero(first)[0]
        counts = np.diff(np.concatenate([starts, [len(did)]]))
        counts = np.minimum(counts, UCHAR_MAX)
        return did[starts], dd[starts], counts

    @staticmethod
    def find_duplicates(ids: np.ndarray, diags: np.ndarray):
        """CacheFriendlyOperations::findDuplicates (computeTotalScore=false).

        Pass 1: entry is a duplicate when its u8-truncated diagonal equals
        the previously seen u8 diagonal for the same id (initial 'previous'
        is 0 — the zeroed-byte-array quirk). Pass 2: among duplicates of an
        id, keep one per run of equal u8 diagonals.
        Returns (ids, diagonals u16) of candidates, ordered by id then scan
        order (reference order is radix-bin order; see module docstring).
        """
        if len(ids) == 0:
            return ids, diags
        order = np.argsort(ids, kind="stable")       # scan order within id
        sid = ids[order]
        sdiag = diags[order]
        d8 = sdiag.astype(np.uint8)
        first_of_id = np.ones(len(sid), dtype=bool)
        first_of_id[1:] = sid[1:] != sid[:-1]
        prev_d8 = np.empty_like(d8)
        prev_d8[0] = 0
        prev_d8[1:] = d8[:-1]
        dup = np.where(first_of_id, d8 == 0, d8 == prev_d8)
        did = sid[dup]
        dd = sdiag[dup]
        dd8 = dd.astype(np.uint8)
        if len(did) == 0:
            return did, dd
        # pass 2: keep first of each run of equal (id, u8 diag)
        keep = np.ones(len(did), dtype=bool)
        same_id = did[1:] == did[:-1]
        keep[1:] = ~(same_id & (dd8[1:] == dd8[:-1]))
        return did[keep], dd[keep]

    # -- stage 2: ungapped diagonal rescoring ---------------------------------

    def make_rescore_profile(self, q_num: np.ndarray, comp_bias: np.ndarray):
        """UngappedAlignment::createProfile: ungapped submat column scores
        plus char((bias/4) +- 0.5) correction."""
        corr = np.trunc(np.where(comp_bias < 0.0, comp_bias / 4 - 0.5,
                                 comp_bias / 4 + 0.5)).astype(np.int64)
        prof = self.ungapped.sub_matrix[q_num, :].astype(np.int64) \
            + corr[:, None]                           # (Lq, alpha)
        return prof

    def diagonal_scores(self, prof: np.ndarray, ids: np.ndarray,
                        diags: np.ndarray, cap: bool = True):
        """min(255, best ungapped score) along each hit's diagonal.

        prof: (Lq, alpha) int64. Batched numpy scan over window positions.
        """
        qlen = prof.shape[0]
        d = diags.astype(np.int16).astype(np.int64)     # signed diagonal
        t_len = self.t_lens[ids]
        qs = np.maximum(d, 0)
        ts = np.maximum(-d, 0)
        n = np.minimum(t_len - ts, qlen - qs)
        n = np.maximum(n, 0)
        base = self.t_offsets[ids] + ts
        max_n = int(n.max()) if len(n) else 0
        score = np.zeros(len(ids), dtype=np.int64)
        best = np.zeros(len(ids), dtype=np.int64)
        for i in range(max_n):
            active = i < n
            tc = self.t_cat[np.where(active, base + i, 0)]
            s = prof[np.minimum(qs + i, qlen - 1), tc]
            score = np.where(active, np.maximum(score + s, 0), score)
            best = np.maximum(best, np.where(active, score, 0))
        if cap:
            return np.minimum(best, UCHAR_MAX)
        return best

    # -- full pipeline --------------------------------------------------------

    def match(self, q_num: np.ndarray, identity_id: int = -1,
              diagonal_scoring: bool = True,
              rescore_profile: np.ndarray = None,
              allowed_mask: np.ndarray = None, generator=None):
        """Returns list of hit tuples (local target id, prefScore,
        diagonal i32) in final output order.

        rescore_profile: for DBTYPE_HMM_PROFILE queries, the (L, 21)
        alignment-scale column scores (pssm/4, X=0). Composition bias is
        zeroed for profiles (QueryMatcher.cpp:109-117) and the diagonal
        rescore reads the profile directly (UngappedAlignment.cpp profile
        branch of createProfile); `generator` is such a query's k-mer
        generator (ProfileKmerGenerator), in place of the matcher's own."""
        if (rescore_profile is None and self.aa_bias_corr
                and not self.is_nucleotide):
            comp_bias = calc_local_aa_bias(
                q_num, self.seed.sub_matrix, self.seed.pback, self.bias_scale)
        else:
            comp_bias = np.zeros(len(q_num), dtype=np.float32)

        ids, diags = self.gather_hits(q_num, comp_bias, generator)

        if not diagonal_scoring:
            # KMER_SCORE path: double-match counts are the prefilter score
            ids, diags, counts = self.find_duplicates_counted(ids, diags)
            if allowed_mask is not None and len(ids):
                keep = allowed_mask[ids]
                ids, diags, counts = ids[keep], diags[keep], counts[keep]
            self.stats.double_matches = int(counts.sum())
            score_sizes = np.bincount(counts, minlength=SCORE_RANGE) \
                if len(counts) else np.zeros(SCORE_RANGE, dtype=np.int64)
            thr = max(self.min_diag_thr,
                      compute_score_threshold(score_sizes, self.max_hits))
            keep = counts >= thr
            ids, diags, counts = ids[keep], diags[keep], counts[keep]
            order = np.argsort(-counts, kind="stable")
            ids, diags, counts = ids[order], diags[order], counts[order]
            hits = []
            if identity_id >= 0:
                hits.append((identity_id, UCHAR_MAX, 0))
            for i in range(len(ids)):
                if len(hits) >= self.max_hits:
                    break
                tid = int(ids[i])
                if identity_id >= 0 and tid == identity_id:
                    continue
                hits.append((tid, int(counts[i]), int(np.int16(diags[i]))))
            start = 1 if identity_id >= 0 else 0
            tail = sorted(hits[start:], key=lambda h: (-abs(h[1]), h[0]))
            return hits[:start] + tail
        ids, diags = self.find_duplicates(ids, diags)
        if allowed_mask is not None and len(ids):
            # QueryMatcherTaxonomyHook: drop disallowed targets AFTER the
            # double-diagonal detection, BEFORE rescoring/truncation
            keep = allowed_mask[ids]
            ids, diags = ids[keep], diags[keep]
        self.stats.double_matches = len(ids)

        prof = (rescore_profile.astype(np.int64)
                if rescore_profile is not None
                else self.make_rescore_profile(q_num, comp_bias))
        counts = self.diagonal_scores(prof, ids, diags) if len(ids) else \
            np.zeros(0, dtype=np.int64)

        if self.is_nucleotide and len(ids):
            # QueryMatcher.cpp:147-177: sort desc >= minDiagScoreThr; among
            # an id's saturated (count==255) diagonals, the first (by id
            # sort) carries the diagonal of the best EXACT rescored one
            keep = counts >= self.min_diag_thr
            ids, diags, counts = ids[keep], diags[keep], counts[keep]
            order = np.argsort(-counts, kind="stable")
            ids, diags, counts = ids[order], diags[order], counts[order]
            n_sat = int((counts >= UCHAR_MAX).sum())
            if n_sat > 1:
                po = np.argsort(ids[:n_sat], kind="stable")
                sid = ids[:n_sat][po]
                sdiag = diags[:n_sat][po]
                exact = self.diagonal_scores(prof, sid, sdiag, cap=False)
                new_diag = sdiag.copy()
                i0 = 0
                while i0 < n_sat:
                    j = i0
                    while j + 1 < n_sat and sid[j + 1] == sid[i0]:
                        j += 1
                    if j > i0:
                        mx = int(exact[i0])
                        bi = i0
                        for k2 in range(i0 + 1, j + 1):
                            if int(exact[k2]) > mx:
                                mx = int(exact[k2])
                                bi = k2
                        new_diag[i0] = sdiag[bi]
                    i0 = j + 1
                ids[:n_sat] = sid
                diags[:n_sat] = new_diag

        # keepMaxScoreElementOnly: per id keep max count (first on ties in
        # scan order)
        if len(ids):
            order = np.lexsort((np.arange(len(ids)), -counts, ids))
            sid, sdiag, scount = ids[order], diags[order], counts[order]
            first = np.ones(len(sid), dtype=bool)
            first[1:] = sid[1:] != sid[:-1]
            ids, diags, counts = sid[first], sdiag[first], scount[first]

        score_sizes = np.bincount(counts, minlength=SCORE_RANGE) \
            if len(counts) else np.zeros(SCORE_RANGE, dtype=np.int64)
        diagonal_thr = compute_score_threshold(score_sizes, self.max_hits)
        diagonal_thr = max(self.min_diag_thr, diagonal_thr)

        # radix sort desc by score, stable (input order within score)
        keep = counts >= diagonal_thr
        ids, diags, counts = ids[keep], diags[keep], counts[keep]
        order = np.argsort(-counts, kind="stable")
        ids, diags, counts = ids[order], diags[order], counts[order]

        rescale = 0
        if diagonal_thr >= UCHAR_MAX:     # scoreIsTruncated (queryBias == 0)
            # rescoreHits: only the saturated (count == 255) prefix survives;
            # exact scores are rescaled into u8 against the query self-score
            sat = counts >= UCHAR_MAX
            ids, diags = ids[sat], diags[sat]
            exact = self.diagonal_scores(prof, ids, diags, cap=False)
            self_max = self._self_score(prof, q_num)
            rescale = max(1, min(self_max - UCHAR_MAX, USHRT_MAX))
            newc = np.minimum(np.maximum(exact - UCHAR_MAX, 0), USHRT_MAX)
            counts = ((newc.astype(np.float32) / np.float32(rescale)
                       * np.float32(UCHAR_MAX) + np.float32(0.5))
                      .astype(np.int64)) & 0xFF
            order = np.argsort(-counts, kind="stable")
            ids, diags, counts = ids[order], diags[order], counts[order]

        # getResult
        hits = []
        if identity_id >= 0:
            hits.append((identity_id, USHRT_MAX, 0))
        n_out = 0
        for i in range(len(ids)):
            if len(hits) >= self.max_hits:
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
                score = int(self.diagonal_scores(
                    prof, np.array([tid]), np.array([diags[i]],
                                                    dtype=np.uint16),
                    cap=False)[0])
            else:
                score = sc
            hits.append((tid, score, int(np.int16(diags[i]))))
            n_out += 1
        # final ordering: |score| desc, local id asc; identity stays first
        start = 1 if identity_id >= 0 else 0
        tail = sorted(hits[start:], key=lambda h: (-abs(h[1]), h[0]))
        return hits[:start] + tail

    def _self_score(self, prof: np.ndarray, q_num: np.ndarray) -> int:
        """Best ungapped self-alignment on diagonal 0 (rescoreHits)."""
        s = prof[np.arange(len(q_num)), q_num]
        run = 0
        best = 0
        for v in s:
            run = max(0, run + int(v))
            best = max(best, run)
        return best
