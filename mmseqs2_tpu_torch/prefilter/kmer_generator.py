"""Similar-k-mer enumeration against the seed substitution matrix.

Reference: src/prefiltering/KmerGenerator.{h,cpp} +
ExtendedSubstitutionMatrix.cpp. A query k-mer expands into all k-mers whose
summed substitution score is >= the (bias-adjusted) k-mer threshold. The
reference precomputes exhaustive sorted score lists for all 2-mers/3-mers and
merges them with score-cutoff cartesian products; we reproduce the same
candidate sets and their order:

  - sub-k-mer rows sorted by score desc, ties by lexicographic letters
    (stable_sort over the cartesian-product iteration order,
    ExtendedSubstitutionMatrix.cpp:calcScoreMatrix)
  - divide strategy: k=6 -> [3,3]; k=7 -> [2,2,3]; k=5 -> [2,3] (the
    setDivideStrategy switch + std::reverse, KmerGenerator.cpp:41-88)
  - output order: first-subkmer-major (descending score), inner candidates
    descending (calculateArrayProduct)

Rows are computed lazily and cached (the reference precomputes all 160k rows;
we only ever touch rows for sub-k-mers that occur in queries).
"""

import numpy as np

from .kmer_index import kmer_powers


class SubKmerScores:
    """Sorted (score desc, tie: lexicographic letters) lists of all A^k
    sub-k-mers scored against a given sub-k-mer.

    Rows live in dense lazily-filled arrays (scores int16, kmer indices
    int32) so the batched generator can gather from them without per-row
    Python. Untouched rows cost no physical memory (np.empty pages fault in
    on first write); a fully-touched 3-mer table at A=20 is 8000x8000 x 6 B
    = 384 MB, matching the reference's precomputed ScoreMatrix
    (ExtendedSubstitutionMatrix.h:13, serialized into `.idx` files)."""

    def __init__(self, sub_matrix: np.ndarray, alpha: int, k: int):
        self.mat = sub_matrix[:alpha, :alpha].astype(np.int32)
        self.alpha = alpha
        self.k = k
        self.size = alpha ** k
        self.powers = kmer_powers(alpha, k)
        # little-endian index <-> big-endian (lexicographic) tie key
        digits = np.stack([(np.arange(self.size) // self.powers[i])
                           % alpha for i in range(k)])
        self._digits = digits.astype(np.int32)
        be = np.zeros(self.size, dtype=np.int64)
        for i in range(k):
            be = be * alpha + digits[i]
        self._bigend = be
        self._scores = np.empty((self.size, self.size), dtype=np.int16)
        self._idx = np.empty((self.size, self.size), dtype=np.int32)
        self._have = np.zeros(self.size, dtype=bool)
        # count-LUT: _cnt[r, c - vmin] = #{j : score(r, j) >= c}. One cheap
        # gather replaces a 13-step binary search into the 384 MB table.
        self._vmin = int(self.mat.min()) * k
        self._vspan = int(self.mat.max()) * k - self._vmin + 1
        self._cnt = np.empty((self.size, self._vspan), dtype=np.int32)

    def letters(self, idx: int):
        return [(idx // int(self.powers[i])) % self.alpha
                for i in range(self.k)]

    def attach_disk_cache(self):
        """Replace the lazy row fill with fully-precomputed tables mmapped
        from a per-(matrix, alpha, k) disk cache (~460 MB for the 3-mer
        table at A=20). The first process computes and saves them; later
        processes fault pages in on demand instead of repeating the row
        fill's argsort. The directory is MMSEQS2_TPU_TORCH_CACHE, by
        default mmseqs2_tpu_torch under the user's cache directory; "off"
        disables the cache."""
        import hashlib
        import os
        # the port's own directory: it shares no file with the JAX package
        loc = os.environ.get(
            "MMSEQS2_TPU_TORCH_CACHE",
            os.path.join(os.environ.get("XDG_CACHE_HOME")
                         or os.path.expanduser("~/.cache"),
                         "mmseqs2_tpu_torch"))
        if loc == "off":
            return self
        key = hashlib.sha256(
            self.mat.tobytes() + bytes([self.alpha, self.k])
        ).hexdigest()[:16]
        base = os.path.join(loc, f"subk{self.k}_{key}")
        names = ("scores", "idx", "cnt")
        try:
            # reap orphaned tmp files (a process that died between np.save
            # and os.replace, incl. old .npy.tmp{pid}.npy-era names); >1 h
            # old means no live writer can still be racing us
            import glob
            import time
            for stale in glob.glob(os.path.join(loc, "subk*.tmp*")):
                try:
                    if time.time() - os.path.getmtime(stale) > 3600:
                        os.unlink(stale)
                except OSError:
                    pass
        except Exception:
            pass
        try:
            if all(os.path.exists(f"{base}.{n}.npy") for n in names):
                self._scores = np.load(f"{base}.scores.npy", mmap_mode="r")
                self._idx = np.load(f"{base}.idx.npy", mmap_mode="r")
                self._cnt = np.load(f"{base}.cnt.npy", mmap_mode="r")
                self._have = np.ones(self.size, dtype=bool)
                return self
            self.ensure_rows(np.arange(self.size))
            os.makedirs(loc, exist_ok=True)
            for n, arr in zip(names, (self._scores, self._idx, self._cnt)):
                # tmp must end in .npy or np.save appends it and the
                # rename source never exists (cache silently never wrote)
                tmp = f"{base}.{n}.tmp{os.getpid()}.npy"
                np.save(tmp, arr)
                os.replace(tmp, f"{base}.{n}.npy")
        except Exception:
            pass
        return self

    def ensure_rows(self, idxs: np.ndarray):
        """Vectorized fill of any not-yet-computed rows in `idxs`."""
        idxs = np.unique(np.asarray(idxs, dtype=np.int64))
        miss = idxs[~self._have[idxs]]
        if len(miss) == 0:
            return
        s = np.zeros((len(miss), self.size), dtype=np.int32)
        for i in range(self.k):
            dr = ((miss // self.powers[i]) % self.alpha).astype(np.int64)
            s += self.mat[dr[:, None], self._digits[i][None, :]]
        # composite sort key: score desc, tie-break lexicographic letters.
        # bigend < size, so a gap of `size` between score levels keeps the
        # key composite unique -> plain argsort reproduces lexsort((be,-s)).
        # |key| <= (k*maxscore+1)*size + size fits int32 for k<=3, A<=21.
        key = (-s) * np.int32(self.size) + self._bigend[None, :].astype(
            np.int32)
        order = np.argsort(key, axis=1)
        self._scores[miss] = np.take_along_axis(s, order, axis=1).astype(
            np.int16)
        self._idx[miss] = order.astype(np.int32)
        # suffix-summed score histogram -> count-of-scores >= cutoff LUT
        flat = (s - self._vmin) + (np.arange(len(miss))[:, None]
                                   * self._vspan)
        hist = np.bincount(flat.ravel(),
                           minlength=len(miss) * self._vspan)
        hist = hist.reshape(len(miss), self._vspan)
        self._cnt[miss] = hist[:, ::-1].cumsum(axis=1,
                                               dtype=np.int32)[:, ::-1]
        self._have[miss] = True

    def count_ge(self, rows: np.ndarray, cutoff: np.ndarray):
        """#{j : score(rows[i], j) >= cutoff[i]} per element, via the LUT."""
        c = cutoff - self._vmin
        inr = c < self._vspan           # above vmax -> 0
        cc = np.clip(c, 0, self._vspan - 1)
        return np.where(inr, self._cnt[rows, cc], 0).astype(np.int64)


def divide_steps(k: int):
    three_cnt = k // 3
    rem = k % 3
    if rem == 0:
        steps = [3] * three_cnt
    elif rem == 1:
        steps = [3] * (three_cnt - 1) + [2, 2]
    else:
        steps = [3] * three_cnt + [2]
    return list(reversed(steps))


class KmerGenerator:
    MAX_RESULT = 262144 * 32

    def __init__(self, kmer_size: int, alpha: int, three: SubKmerScores,
                 two: SubKmerScores):
        self.k = kmer_size
        self.alpha = alpha
        self.steps = divide_steps(kmer_size)
        self.tables = {2: two, 3: three}
        self.powers = kmer_powers(alpha, kmer_size)

    def generate_all(self, windows: np.ndarray, thresholds: np.ndarray,
                     positions: np.ndarray = None):
        """All similar k-mer indices with score >= threshold, for all
        windows of a query at once.

        windows: (W, k) int letters; thresholds: (W,) per-window (bias
        adjusted) score cutoffs. Returns (codes int64, window_of int64) —
        the concatenation of the per-window enumerations, each in the
        reference's order (KmerGenerator::generateKmerList's cascaded
        cutoff products, KmerGenerator.cpp:30-110; the JAX package's
        per-window `generate`). `positions` is unused for sequence queries
        (profile generators key rows off it)."""
        W = len(windows)
        steps = []
        off = 0
        for step in self.steps:
            table = self.tables[step]
            sub = windows[:, off:off + step].astype(np.int64) @ table.powers
            table.ensure_rows(sub)
            steps.append((table._scores, table._idx, sub,
                          int(self.powers[off]), table.count_ge))
            off += step
        return _expand_batch(steps, np.asarray(thresholds, np.int64),
                             self.MAX_RESULT)


class ProfileKmerGenerator:
    """Per-position k-mer enumeration for DBTYPE_HMM_PROFILE queries.

    Reference: KmerGenerator::setDivideStrategy(ScoreMatrix **one)
    (KmerGenerator.cpp:31-40) + Sequence::nextProfileKmer — each window
    position contributes its rankedDescSort20-sorted 20-letter score row;
    the same score-cutoff cartesian product enumerates all k-mers whose
    summed per-position profile score reaches the threshold.
    """

    MAX_RESULT = KmerGenerator.MAX_RESULT

    def __init__(self, kmer_size: int, alpha: int,
                 sorted_scores: np.ndarray, sorted_idx: np.ndarray,
                 offsets: np.ndarray):
        self.k = kmer_size
        self.alpha = alpha
        self.scores = sorted_scores.astype(np.int64)   # (L, 20) desc
        self.idx = sorted_idx.astype(np.int64)         # (L, 20)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.powers = kmer_powers(alpha, kmer_size)

    def count_ge(self, rows: np.ndarray, cutoff: np.ndarray):
        if not hasattr(self, "_cnt"):
            vmin = int(self.scores.min())
            vspan = int(self.scores.max()) - vmin + 1
            m, w = self.scores.shape
            flat = (self.scores - vmin) + np.arange(m)[:, None] * vspan
            hist = np.bincount(flat.ravel().astype(np.int64),
                               minlength=m * vspan).reshape(m, vspan)
            self._cnt = hist[:, ::-1].cumsum(axis=1,
                                             dtype=np.int32)[:, ::-1]
            self._vmin, self._vspan = vmin, vspan
        c = cutoff - self._vmin
        inr = c < self._vspan
        cc = np.clip(c, 0, self._vspan - 1)
        return np.where(inr, self._cnt[rows, cc], 0).astype(np.int64)

    def generate_all(self, windows: np.ndarray, thresholds: np.ndarray,
                     positions: np.ndarray = None):
        """Batched per-position enumeration; `positions` are the window
        start positions in the profile (row = position + step offset)."""
        positions = np.asarray(positions, dtype=np.int64)
        steps = [(self.scores, self.idx,
                  positions + int(o), int(self.powers[j]), self.count_ge)
                 for j, o in enumerate(self.offsets)]
        return _expand_batch(steps, np.asarray(thresholds, np.int64),
                             self.MAX_RESULT)


class _TooBig(Exception):
    pass


def _expand_batch(steps, thr: np.ndarray, max_result: int,
                  budget: int = 1 << 26):
    """All windows' cascaded cutoff cartesian products
    (KmerGenerator::generateKmerList) in one pass of numpy segment ops.

    steps: per divide step (scores_2d desc-sorted, idx_2d, row_of_window,
    little-endian multiplier). Returns (codes, window_of); the slice of
    `codes` where window_of == w is window w's enumeration, prefix-major
    (calculateArrayProduct's i-outer/j-inner loop), cut at max_result
    candidates (the window's first ones). If a step
    would materialize more than `budget` candidates, the window set is
    split in half and retried (identical output, bounded memory)."""
    W = len(thr)
    try:
        return _expand_batch_once(steps, thr, max_result, budget)
    except _TooBig:
        mid = W // 2
        lo = _expand_batch([(s, i, r[:mid], m, c)
                            for s, i, r, m, c in steps],
                           thr[:mid], max_result, budget)
        hi = _expand_batch([(s, i, r[mid:], m, c)
                            for s, i, r, m, c in steps],
                           thr[mid:], max_result, budget)
        return (np.concatenate([lo[0], hi[0]]),
                np.concatenate([lo[1], hi[1] + mid]))


def _expand_batch_once(steps, thr, max_result, budget):
    n = len(steps)
    W = len(thr)
    # the hot intermediates run in i32 (half the memory traffic of the
    # old i64 path — this loop gathers millions of elements per query):
    # scores/cutoffs are tiny, rep/jj are bounded by `budget` < 2^31, and
    # k-mer codes fit i32 for every real alphabet/k (21^7 < 2^31); fall
    # back to i64 codes if a config ever exceeds it
    code_bound = sum(int(s[3]) * (s[0].shape[1] - 1) for s in steps) + 1
    idt = np.int32 if code_bound < (1 << 31) else np.int64
    empty = (np.zeros(0, idt), np.zeros(0, np.int64))
    if W == 0:
        return empty
    thr = np.asarray(thr, np.int32)
    highest = [s[0][s[2], 0].astype(np.int32) for s in steps]
    rest = [np.zeros(W, np.int32) for _ in range(n)]
    for i in range(n - 1, 0, -1):
        rest[i - 1] = highest[i] + rest[i]

    scores0, idx0, rows0, mult0, count0 = steps[0]
    cnt = count0(rows0, thr - rest[0])
    total = int(cnt.sum())
    if total == 0:
        return empty
    win_of = np.repeat(np.arange(W, dtype=np.int64), cnt)
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    j = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    r = rows0[win_of]
    cur_scores = scores0[r, j].astype(np.int32)
    cur_index = idx0[r, j].astype(idt, copy=False) * idt(mult0)

    for si in range(1, n):
        scores_s, idx_s, rows_s, mult, count_s = steps[si]
        rs = rows_s[win_of]
        cutoff2 = thr[win_of] - cur_scores - rest[si][win_of]
        cnt2 = count_s(rs, cutoff2)
        # pre-truncate at the per-window MAX_RESULT cap WITHOUT
        # materializing: a window's candidates are contiguous, so clamping
        # each candidate's count to what fits below the cap reproduces
        # "materialize then keep the first max_result" exactly
        prev = np.cumsum(cnt2) - cnt2           # exclusive prefix (global)
        wfirst = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        start_in_w = prev - prev[wfirst[win_of]] \
            if len(prev) else prev
        cnt2 = np.clip(max_result - start_in_w, 0, cnt2)
        total2 = int(cnt2.sum())
        if total2 == 0:
            return empty
        if total2 > budget and W > 1:
            raise _TooBig
        rep = np.repeat(np.arange(len(cur_scores), dtype=np.int32), cnt2)
        st = np.concatenate([[0], np.cumsum(cnt2)[:-1]])
        jj = (np.arange(total2, dtype=np.int64)
              - np.repeat(st, cnt2)).astype(np.int32, copy=False)
        rsr = rs[rep]
        cur_scores = cur_scores[rep] + scores_s[rsr, jj].astype(np.int32)
        cur_index = cur_index[rep] + idx_s[rsr, jj].astype(
            idt, copy=False) * idt(mult)
        win_of = win_of[rep]
        cnt = np.bincount(win_of, minlength=W)
    return cur_index, win_of
