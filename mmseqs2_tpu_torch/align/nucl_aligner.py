"""Banded nucleotide aligner: ungapped diagonal seed + ksw2 Z-drop extension.

Port of mmseqs2_tpu/align/nucl_aligner.py. Reproduces
BandedNucleotideAligner (reference
src/alignment/BandedNucleotideAligner.cpp): rescore the
prefilter diagonal with the ungapped start/end alignment (including the
u16-diagonal unfolding of DistanceCalculator::computeUngappedAlignment),
take the all-M shortcut on full coverage, otherwise reverse-extend from the
ungapped end with ksw2-extz (score-only) to find the start, then
forward-extend with cigar; fall back to the reversed-cigar variant when the
reverse extension reached further on both axes. Every ksw2 extension runs
on the host through the native batch core (align/ksw2.py:extz2_batch), as
the reference and the JAX package run this aligner on the host.
"""

import numpy as np

from ..commands.rescorediagonal import local_best
from . import util
from .aligner import AlnResult
from .ksw2 import EXTZ_ONLY, SCORE_ONLY, extz2_batch


def compute_ungapped_alignment(q_num, t_num, diagonal_u16, sub_matrix):
    """DistanceCalculator::computeUngappedAlignment (RESCORE_MODE_ALIGNMENT):
    tries the u16 diagonal un-foldings and keeps the best-scoring one.
    Returns (score, start, end, signed_diagonal, dist_to_diagonal)."""
    qlen, tlen = len(q_num), len(t_num)
    best = (0, -1, -1, 0, 0)
    reals = [-(d + 1) * 65536 + diagonal_u16 for d in range(1 + tlen // 32768)]
    reals += [d * 65536 + diagonal_u16 for d in range(1 + qlen // 65536)]
    for real in reals:
        dist = abs(real)
        if real >= 0 and dist < qlen:
            n = min(tlen, qlen - dist)
            scores = sub_matrix[q_num[dist:dist + n], t_num[:n]]
        elif real < 0 and dist < tlen:
            n = min(tlen - dist, qlen)
            scores = sub_matrix[q_num[:n], t_num[dist:dist + n]]
        else:
            continue
        sc, s, e = local_best(scores)
        if sc > best[0]:
            best = (sc, s, e, real, dist)
    return best


def compute_ungapped_wrapped(q2, t_num, diagonal_u16, sub_matrix):
    """DistanceCalculator::computeUngappedWrappedAlignment
    (DistanceCalculator.h:57-90): slide an origQueryLen window over the
    doubled query at each u16 diagonal unfolding, score it ungapped on
    diagonal 0 against the whole target, keep the best.  Windows with a
    negative offset read out of bounds in the reference and are skipped
    here.  Returns (score, start, end, signed_diagonal, dist)."""
    qlen, tlen = len(q2), len(t_num)
    half = qlen // 2
    best = (0, -1, -1, 0, 0)
    reals = []
    dev = 1
    while -dev * 65536 + diagonal_u16 > -tlen:
        reals.append(-dev * 65536 + diagonal_u16 + half)
        dev += 1
    dev = 0
    while dev * 65536 + diagonal_u16 < half:
        reals.append(dev * 65536 + diagonal_u16)
        dev += 1
    for real in reals:
        if real < 0 or real + half > qlen:
            continue
        n = min(half, tlen)
        scores = sub_matrix[q2[real:real + n], t_num[:n]]
        sc, st, en = local_best(scores)
        if sc > best[0]:
            best = (sc, st, en, real, abs(real))
    return best


class NuclAligner:
    def __init__(self, submat, gap_open: int, gap_extend: int, zdrop: int,
                 evaluer):
        self.submat = submat
        self.mat = submat.sub_matrix[:submat.alphabet_size,
                                     :submat.alphabet_size].astype(np.int64)
        self.mat_flat = self.mat.ravel().tolist()
        self.m = submat.alphabet_size
        self.go = int(gap_open)
        self.ge = int(gap_extend)
        self.zdrop = int(zdrop)
        self.evaluer = evaluer

    def _map_buffer(self, name: str, seq: np.ndarray) -> int:
        """Emulate the reference's reused Sequence/aligner buffers: writing
        seq into [0, L) leaves [L] holding the previous longer content (the
        stale byte that seq_reverse's off-by-one picks up)."""
        buf = getattr(self, name, None)
        if buf is None or len(buf) < len(seq) + 1:
            newbuf = np.zeros(max(len(seq) + 1, 10001), dtype=np.int64)
            if buf is not None:
                newbuf[:len(buf)] = buf
            buf = newbuf
            setattr(self, name, buf)
        stale = int(buf[len(seq)])
        buf[:len(seq)] = seq
        return stale

    @staticmethod
    def _seq_reverse(seq: np.ndarray, stale: int) -> np.ndarray:
        """SmithWaterman::seq_reverse(dst, src, L) reverses L+1 elements:
        rev[i] = seq[L-i], so rev[0] is the buffer's stale byte at [L] and
        seq[0] is dropped (StripedSmithWaterman.h:224-234)."""
        return np.concatenate(([stale], seq[1:][::-1]))

    def init_query(self, q_num: np.ndarray):
        q = np.asarray(q_num, dtype=np.int64)
        self.q = q
        stale_q = self._map_buffer("_qbuf", q)
        self.q_rev = self._seq_reverse(q, stale_q)
        rc = self.submat.reverse_lookup[q.astype(np.uint8)][::-1] \
            .astype(np.int64)
        self.q_revcomp = rc
        stale_rc = self._map_buffer("_rcbuf", rc)
        self.q_revcomp_rev = self._seq_reverse(rc, stale_rc)

    def align(self, t_num: np.ndarray, diagonal: int, reverse: bool,
              wrapped: bool = False):
        """One gapped nucleotide alignment; returns an AlnResult.

        With `wrapped` the query was doubled by the caller for circular
        end-start scoring (BandedNucleotideAligner.cpp:100-110,189-191):
        the ungapped seed scans origQueryLen windows, the ksw2 extensions
        are capped at origQueryLen, and coverage/E-value use origQueryLen.
        """
        return self.align_pairs([t_num], [diagonal], [reverse],
                                wrapped=wrapped)[0]

    def align_pairs(self, t_list, diag_list, rev_list, wrapped=False):
        """align() over many targets of the current query, the three ksw2
        extension calls batched through extz2_batch (per pair the results
        of the sequential path, including the reused-buffer staleness:
        phase 1 walks targets in call order, so the buffer history matches
        the reference's)."""
        n = len(t_list)
        metas = [None] * n
        results = [None] * n
        for i in range(n):
            q = self.q_revcomp if rev_list[i] else self.q
            q_rev = self.q_revcomp_rev if rev_list[i] else self.q_rev
            t = np.asarray(t_list[i], dtype=np.int64)
            stale_t = self._map_buffer("_tbuf", t)
            t_rev = self._seq_reverse(t, stale_t)
            qlen, tlen = len(q), len(t)
            orig_qlen = qlen // 2 if wrapped else qlen
            diagonal = diag_list[i]
            if wrapped:
                if qlen >= tlen * 2:
                    sc, us, ue, diag, dist = compute_ungapped_wrapped(
                        q, t, diagonal & 0xFFFF, self.mat)
                else:
                    sc, us, ue, diag, dist = compute_ungapped_alignment(
                        q[:orig_qlen], t, diagonal & 0xFFFF, self.mat)
            else:
                sc, us, ue, diag, dist = compute_ungapped_alignment(
                    q, t, diagonal & 0xFFFF, self.mat)
            if diag >= 0:
                q_us, q_ue = us + dist, ue + dist
                db_us, db_ue = us, ue
            else:
                q_us, q_ue = us, ue
                db_us, db_ue = us + dist, ue + dist
            if (q_ue - q_us == orig_qlen - 1 and db_us == 0
                    and db_ue == tlen - 1):
                aa_ids = int((q[q_us:q_ue + 1] == t[db_us:db_ue + 1]).sum())
                results[i] = self._result(sc, q_us, q_ue, db_us, db_ue,
                                          qlen, tlen, "M" * orig_qlen,
                                          aa_ids, wrapped)
                continue
            q_start_rev = (qlen - q_ue) - 1
            t_start_rev = (tlen - db_ue) - 1
            rev_len = qlen - q_start_rev
            if wrapped and rev_len > orig_qlen:
                rev_len = orig_qlen
            metas[i] = dict(q=q, q_rev=q_rev, t=t, t_rev=t_rev, qlen=qlen,
                            tlen=tlen, orig_qlen=orig_qlen,
                            q_start_rev=q_start_rev,
                            t_start_rev=t_start_rev, rev_len=rev_len)

        idxs = [i for i in range(n) if metas[i] is not None]
        if not idxs:
            return results
        # pass 1: reverse extension (score + end positions only)
        ez1 = extz2_batch(
            [metas[i]["q_rev"][metas[i]["q_start_rev"]:
                               metas[i]["q_start_rev"]
                               + metas[i]["rev_len"]] for i in idxs],
            [metas[i]["t_rev"][metas[i]["t_start_rev"]:] for i in idxs],
            self.mat_flat, self.m, self.go, self.ge, 64, self.zdrop,
            SCORE_ONLY | EXTZ_ONLY)
        # pass 2: forward extension with direction bytes + backtrack
        fq, ft = [], []
        for k, i in enumerate(idxs):
            m_ = metas[i]
            ez = ez1[k]
            q_start = m_["qlen"] - (m_["q_start_rev"] + ez.max_q) - 1
            t_start = m_["tlen"] - (m_["t_start_rev"] + ez.max_t) - 1
            fwd_len = m_["qlen"] - q_start
            if wrapped and fwd_len > m_["orig_qlen"]:
                fwd_len = m_["orig_qlen"]
            m_.update(ez=ez, q_start=q_start, t_start=t_start)
            fq.append(m_["q"][q_start:q_start + fwd_len])
            ft.append(m_["t"][t_start:])
        ez2 = extz2_batch(fq, ft, self.mat_flat, self.m, self.go, self.ge,
                          64, self.zdrop, EXTZ_ONLY)
        # pass 3: conditional reverse re-extension with cigar
        third = [k for k, i in enumerate(idxs)
                 if metas[i]["ez"].max_q > ez2[k].max_q
                 and metas[i]["ez"].max_t > ez2[k].max_t]
        ez3 = extz2_batch(
            [metas[idxs[k]]["q_rev"][metas[idxs[k]]["q_start_rev"]:
                                     metas[idxs[k]]["q_start_rev"]
                                     + metas[idxs[k]]["rev_len"]]
             for k in third],
            [metas[idxs[k]]["t_rev"][metas[idxs[k]]["t_start_rev"]:]
             for k in third],
            self.mat_flat, self.m, self.go, self.ge, 64, self.zdrop,
            EXTZ_ONLY) if third else []
        third_map = {k: ez3[j] for j, k in enumerate(third)}

        for k, i in enumerate(idxs):
            m_ = metas[i]
            if k in third_map:
                ez_aln = third_map[k]
                cigar = list(reversed(ez_aln.cigar))
            else:
                ez_aln = ez2[k]
                cigar = ez_aln.cigar
            q, t = m_["q"], m_["t"]
            q_start, t_start = m_["q_start"], m_["t_start"]
            q_end = q_start + ez_aln.max_q
            db_end = t_start + ez_aln.max_t
            backtrace = []
            aa_ids = 0
            qi, ti = q_start, t_start
            for op, length in cigar:
                if op == 0:
                    aa_ids += int((q[qi:qi + length]
                                   == t[ti:ti + length]).sum())
                    backtrace.append("M" * length)
                    qi += length
                    ti += length
                elif op == 1:
                    backtrace.append("I" * length)
                    qi += length
                else:
                    backtrace.append("D" * length)
                    ti += length
            results[i] = self._result(ez_aln.max, q_start, q_end, t_start,
                                      db_end, m_["qlen"], m_["tlen"],
                                      "".join(backtrace), aa_ids, wrapped)
        return results

    def _result(self, score, qs, qe, ts, te, qlen, tlen, backtrace, aa_ids,
                wrapped=False):
        orig_qlen = qlen // 2 if wrapped else qlen
        ev = self.evaluer.compute_evalue(int(score), orig_qlen)
        qcov = float(util.compute_cov(int(qs), int(qe), qlen))
        if wrapped:
            # doubled-query coverage is rescaled and capped
            # (BandedNucleotideAligner.cpp:146-147,224-226)
            qcov = min(1.0, qcov * 2)
        res = AlnResult(
            db_key=-1,
            score=int(self.evaluer.compute_bit_score(int(score)) + 0.5),
            raw_score=int(score), seq_id=0.0, eval=ev,
            q_start=int(qs), q_end=int(qe), q_len=orig_qlen,
            db_start=int(ts), db_end=int(te), db_len=tlen,
            qcov=qcov,
            dbcov=float(util.compute_cov(int(ts), int(te), tlen)),
            aln_length=len(backtrace), backtrace=backtrace)
        res.aa_ids = aa_ids
        return res
