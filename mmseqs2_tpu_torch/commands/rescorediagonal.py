"""`rescorediagonal`: re-score prefilter hits along their diagonal.

Reference: src/alignment/rescorediagonal.cpp + DistanceCalculator.h.
Modes: 0 HAMMING (count identical ASCII bytes), 1 SUBSTITUTION (best local
ungapped score), 2 ALIGNMENT (local ungapped with start/end), 3 END_TO_END,
4 WINDOW_QUALITY (longest <=5-errors-per-20 window stretch). Scores use an ASCII-indexed 2-bit
substitution matrix (createAsciiSubMat), i.e. raw sequence bytes, so masked
lowercase letters score like their uppercase forms but differ under HAMMING.

Output: modes 0/1 -> prefilter-format (`key \t score \t diagonal`); modes
2/3 -> alignment-format records.
"""

import numpy as np

from ..align import util as autil
from ..align.aligner import AlnResult, sort_results
from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..utils import log
from .common import parse_prefilter_entry

RESCORE_HAMMING = 0
RESCORE_SUBSTITUTION = 1
RESCORE_ALIGNMENT = 2
RESCORE_END_TO_END = 3
RESCORE_WINDOW_QUALITY = 4


def window_quality_best(q_win, t_win, col, window_size=20,
                        history_errors=5):
    """computeWindowQualitySubstitutionStartEndDistance
    (DistanceCalculator.h:222-271): longest stretch whose every
    `window_size`-residue window holds <= `history_errors` mismatches;
    score is the substitution sum over [start, end) (end EXCLUSIVE,
    reproducing the reference's loop bound)."""
    length = len(q_win)
    window = 0
    window_mask = 1 << (window_size - 1)
    curr_errors = 0
    max_len = 0
    curr_len = 0
    max_end = max_start = 0
    star = ord("*")
    first = 1 if length and (q_win[0] == star or t_win[0] == star) else 0
    last = length - 1
    if last > 0 and (q_win[last] == star or t_win[last] == star):
        last -= 1
    start_pos = first
    match = q_win == t_win
    for pos in range(first, last + 1):
        if window & window_mask:
            curr_errors -= 1
        window = (window << 1) & ((1 << window_size) - 1)
        if not match[pos]:
            window |= 1
            curr_errors += 1
        curr_len += 1
        if pos >= window_size - 1 and curr_errors > history_errors:
            start_pos = pos - window_size + 2
            curr_len = window_size - 1
        if curr_len > max_len:
            max_start = start_pos
            max_end = pos
            max_len = curr_len
    score = int(col[max_start:max_end].sum()) if max_end > max_start else 0
    return score, max_start, max_end


def ascii_submat(submat):
    """ASCII x ASCII score lookup (SubstitutionMatrix::createAsciiSubMat)."""
    table = submat.make_aa2num_table()
    rng = np.arange(123)       # 0..'z'
    idx = table[rng]
    return submat.sub_matrix[np.ix_(idx, idx)].astype(np.int64)


def local_best(scores: np.ndarray):
    """(score, start, end) of the best non-negative run (reference
    computeSubstitutionStartEndDistance tie-breaks: later maxima do NOT
    replace; only strictly greater)."""
    best = 0
    best_s = 0
    best_e = 0
    run = 0
    min_pos = -1
    for pos, v in enumerate(scores):
        run += int(v)
        if run <= 0:
            run = 0
            min_pos = pos
        if run > best:
            best = run
            best_e = pos
            best_s = min_pos + 1
    return best, best_s, best_e


def diagonal_window(q_len, t_len, diagonal):
    """Signed-diagonal overlap window (DistanceCalculator semantics).

    Returns (q_start, t_start, length) or None."""
    d = int(np.int16(np.array(diagonal).astype(np.int64).astype(np.uint16)))
    dist = abs(d)
    if d >= 0 and dist < q_len:
        return dist, 0, min(t_len, q_len - dist), d
    if d < 0 and dist < t_len:
        return 0, dist, min(t_len - dist, q_len), d
    return None


def parse_precision_lib(text: str, target_seqid: float, target_cov: float,
                        target_precision: float) -> float:
    """parsePrecisionLib (rescorediagonal.cpp:18-39): score-per-column
    threshold giving >= targetPrecision at the rounded (cov, seqid) cell."""
    int_seqid = int((target_seqid + 0.0001) * 100)
    target_seqid = float(int_seqid - int_seqid % 5) / 100
    target_cov = float(int((target_cov + 0.0001) * 10)) / 10
    for line in text.splitlines():
        vals = line.split()
        if len(vals) < 4:
            continue
        cov, seqid, score_per_col, precision = (float(v) for v in vals[:4])
        if (abs(cov - target_cov) < 1e-6 and abs(seqid - target_seqid) < 1e-6
                and precision >= target_precision):
            return score_per_col
    log.warning(f"No score per column for coverage {target_cov} and sequence "
             f"identity {target_seqid}. No hit will be filtered.")
    return 0.0


def _wrapped_best_window(q2, t_seq, diagonal_u16, orig_qlen, amat, mode):
    """computeUngappedWrappedAlignment (DistanceCalculator.h:57-90): score
    an orig-query-length window of the doubled query at every u16 diagonal
    unfolding with the mode-specific ungapped scorer, keep the strict best.
    Negative window offsets read out of bounds in the reference and are
    skipped.  Returns (q_offset, 0, n, diagonal) like diagonal_window."""
    tlen = len(t_seq)
    n = min(orig_qlen, tlen)
    reals = []
    dev = 1
    while -dev * 65536 + diagonal_u16 > -tlen:
        reals.append(-dev * 65536 + diagonal_u16 + orig_qlen)
        dev += 1
    dev = 0
    while dev * 65536 + diagonal_u16 < orig_qlen:
        reals.append(dev * 65536 + diagonal_u16)
        dev += 1
    best = None
    best_score = 0
    for real in reals:
        if real < 0 or real + n > len(q2):
            continue
        qw = q2[real:real + n]
        tw = t_seq[:n]
        col = amat[qw, tw]
        if mode == RESCORE_HAMMING:
            sc = int((qw == tw).sum())
        elif mode == RESCORE_SUBSTITUTION:
            c = np.cumsum(col)
            pm = np.minimum(np.minimum.accumulate(
                np.concatenate([[0], c[:-1]])), 0)
            sc = max(0, int((c - pm).max()))
        elif mode == RESCORE_WINDOW_QUALITY:
            sc = window_quality_best(qw, tw, col)[0]
        elif mode == RESCORE_END_TO_END:
            sc = int(col.sum())
        else:
            sc = local_best(col)[0]
        if best is None or sc > best_score:
            best = (real, 0, n, real)
            best_score = sc
    return best


def rescorediagonal(par, command):
    q_path, t_path, res_path, out_path = par.filenames[:4]
    same_db = q_path == t_path
    qdb = DBReader(q_path)
    tdb = qdb if same_db else DBReader(t_path)
    res = DBReader(res_path)
    # nucleotide inputs use the nucleotide matrix at scale 1.0
    # (rescorediagonal.cpp:83-88)
    if qdb.base_type == dbt.DBTYPE_NUCLEOTIDES:
        submat = get_submat(par.sub_mat.nucl, 1.0, 0.0)
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    amat = ascii_submat(submat)
    evaluer = EvalueComputation(tdb.total_residues(), submat, 0, 0)
    mode = par.rescore_mode
    wrapped = bool(par.wrapped_scoring)
    if wrapped and qdb.base_type != dbt.DBTYPE_NUCLEOTIDES:
        log.die("Wrapped scoring is only supported for nucleotides.")
    rev_pref = res.base_type == dbt.DBTYPE_PREFILTER_REV_RES
    rc_table = None
    if rev_pref:
        rc_table = np.arange(256, dtype=np.uint8)
        for a, b in ((ord("A"), ord("T")), (ord("C"), ord("G")),
                     (ord("a"), ord("t")), (ord("c"), ord("g"))):
            rc_table[a], rc_table[b] = b, a
    score_per_col_thr = 0.0
    if par.filter_hits:
        if mode == RESCORE_HAMMING:
            log.warning("HAMMING distance can not be used to filter hits. "
                     "Using --rescore-mode 1")
            mode = RESCORE_SUBSTITUTION
        from ..data import precision_libs
        lib = (precision_libs.COV_SEQID_QSC_MINDIAG
               if par.cov_mode == 0
               else precision_libs.COV_SEQID_QSC_MINDIAG_TARGETCOV)
        score_per_col_thr = parse_precision_lib(lib, par.min_seq_id,
                                                par.cov_thr, 0.99)

    out_type = dbt.DBTYPE_ALIGNMENT_RES if mode in (
        RESCORE_ALIGNMENT, RESCORE_END_TO_END,
        RESCORE_WINDOW_QUALITY) else (
        dbt.DBTYPE_PREFILTER_REV_RES if rev_pref
        else dbt.DBTYPE_PREFILTER_RES)
    writer = DBWriter(out_path, out_type)

    for i in range(res.size):
        q_key = res.get_db_key(i)
        data = res.get_data(i)
        lines = []
        aln_results = []
        if data:
            qid = qdb.get_id(q_key)
            q_fwd = np.frombuffer(qdb.get_seq(qid), dtype=np.uint8)
            q_len = len(q_fwd)
            full_qlen = q_len
            if wrapped:
                # double the query for circular end-start scoring
                # (rescorediagonal.cpp:166-171); stats use the original len
                q_fwd = np.concatenate([q_fwd, q_fwd])
                full_qlen = 2 * q_len
            q_rev_seq = None
            if rev_pref:
                # reverse complement at the byte level
                # (rescorediagonal.cpp:177-183)
                q_rev_seq = rc_table[q_fwd[::-1]]
            keys, scores_in, diags = parse_prefilter_entry(data)
            for key, score_in, diag in zip(keys, scores_in, diags):
                is_rev = rev_pref and score_in < 0
                q_seq = q_rev_seq if is_rev else q_fwd
                tid = tdb.get_id(key)
                t_seq = np.frombuffer(tdb.get_seq(tid), dtype=np.uint8)
                t_len = len(t_seq)
                is_identity = (qid == tid and (par.include_identity
                                               or same_db))
                if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                            float(q_len), float(t_len)):
                    continue
                if wrapped and t_len <= q_len:
                    win = _wrapped_best_window(q_seq, t_seq, diag, q_len,
                                               amat, mode)
                else:
                    win = diagonal_window(q_len, t_len, diag)
                if win is None:
                    continue
                qs, ts, n, d = win
                qw = q_seq[qs: qs + n]
                tw = t_seq[ts: ts + n]
                col = amat[qw, tw]
                seq_id = 0.0
                evalue = 0.0
                bit_score = 0
                aln_len = 0
                q_cov = np.float32(n) / np.float32(q_len)
                t_cov = np.float32(n) / np.float32(t_len)
                result = None
                if mode == RESCORE_HAMMING:
                    distance = int((qw == tw).sum())
                    seq_id = autil.compute_seq_id(par.seq_id_mode, distance,
                                                  q_len, t_len, n)
                    aln_len = n
                else:
                    if mode == RESCORE_SUBSTITUTION:
                        if n:
                            c = np.cumsum(col)
                            pm = np.minimum(np.minimum.accumulate(
                                np.concatenate([[0], c[:-1]])), 0)
                            distance = max(0, int((c - pm).max()))
                        else:
                            distance = 0
                    elif mode == RESCORE_WINDOW_QUALITY:
                        distance, start, end = window_quality_best(qw, tw,
                                                                   col)
                    else:
                        distance, start, end = local_best(col)
                    evalue = evaluer.compute_evalue(distance, q_len)
                    bit_score = int(evaluer.compute_bit_score(distance) + 0.5)
                    if mode in (RESCORE_ALIGNMENT, RESCORE_END_TO_END,
                                RESCORE_WINDOW_QUALITY):
                        if mode == RESCORE_END_TO_END:
                            start, end = 0, n - 1
                            distance = max(int(col.sum()), 0)
                            evalue = evaluer.compute_evalue(distance, q_len)
                            bit_score = int(
                                evaluer.compute_bit_score(distance) + 0.5)
                        aln_len = end - start + 1
                        if d >= 0:
                            q_s, q_e = start + qs, end + qs
                            t_s, t_e = start, end
                        else:
                            q_s, q_e = start, end
                            t_s, t_e = start + ts, end + ts
                        if evalue <= par.evalue or is_identity:
                            upper_q = q_seq[q_s: q_e + 1] & ~np.uint8(0x20)
                            upper_t = t_seq[t_s: t_e + 1] & ~np.uint8(0x20)
                            id_cnt = int((upper_q == upper_t).sum())
                            seq_id = autil.compute_seq_id(
                                par.seq_id_mode, id_cnt, q_len, t_len,
                                aln_len)
                        q_cov = autil.compute_cov(q_s, q_e, q_len)
                        t_cov = autil.compute_cov(t_s, t_e, t_len)
                        if is_rev:
                            # reversed hits report flipped query coords
                            # (rescorediagonal.cpp:310-313)
                            q_s = full_qlen - q_s - 1
                            q_e = full_qlen - q_e - 1
                        bt = "M" * aln_len if par.add_backtrace else ""
                        result = AlnResult(
                            db_key=key, score=bit_score, raw_score=distance,
                            seq_id=float(seq_id), eval=evalue,
                            q_start=q_s, q_end=q_e, q_len=q_len,
                            db_start=t_s, db_end=t_e, db_len=t_len,
                            qcov=float(q_cov), dbcov=float(t_cov),
                            aln_length=aln_len, backtrace=bt)

                has_cov = autil.has_coverage(par.cov_thr, par.cov_mode,
                                             q_cov, t_cov)
                has_seq_id = seq_id >= (par.min_seq_id
                                        - np.finfo(np.float32).eps)
                has_eval = evalue <= par.evalue
                has_aln_len = aln_len >= par.min_aln_len
                curr_score_per_col = (np.float32(distance) / np.float32(n)
                                      if n else np.float32(0))
                has_to_filter = (par.filter_hits
                                 and curr_score_per_col >= score_per_col_thr)
                if is_identity or has_to_filter or (
                        has_aln_len and has_cov and has_seq_id and has_eval):
                    if mode in (RESCORE_ALIGNMENT, RESCORE_END_TO_END,
                                RESCORE_WINDOW_QUALITY):
                        aln_results.append(result)
                    elif mode == RESCORE_SUBSTITUTION:
                        out_sc = -bit_score if is_rev else bit_score
                        lines.append(f"{key}\t{out_sc}\t{d}\n")
                    else:
                        # seqId is held in a double in the reference, so
                        # 100*0.11f = 10.9999... truncates to 10
                        out_sc = int(100 * np.float64(seq_id))
                        if is_rev:
                            out_sc = -out_sc
                        lines.append(f"{key}\t{out_sc}\t{d}\n")
        if par.sort_results > 0 and len(aln_results) > 1:
            sort_results(aln_results)
        if aln_results:
            lines = [r.to_line(par.add_backtrace) for r in aln_results]
        elif par.sort_results > 0 and len(lines) > 1:
            # hit_t::compareHitsByScoreAndId over the prefilter-format lines
            def hit_key(ln):
                parts = ln.split("\t")
                return (-abs(int(parts[1])), int(parts[0]))
            lines.sort(key=hit_key)
        writer.write(q_key, "".join(lines).encode())
    writer.close()
    return 0
