"""Alignment acceptance predicates and record formatting.

Byte-exact counterparts of reference helpers:
  - Util::hasCoverage / canBeCovered / computeSeqId / hasAlignmentLength
    (reference src/commons/Util.cpp:542-607)
  - Matcher::resultToBuffer (reference src/alignment/Matcher.cpp:282-325)
  - Util::fastSeqIdToBuffer — including its seqId == 1.0 quirk, which emits
    "1.00" (the trailing digit is overwritten by the tab)
    (reference src/commons/Util.cpp:251-280)
  - Matcher::compressAlignment run-length cigar compression
"""

import numpy as np

COV_MODE_BIDIRECTIONAL = 0
COV_MODE_TARGET = 1
COV_MODE_QUERY = 2
COV_MODE_LENGTH_QUERY = 3
COV_MODE_LENGTH_TARGET = 4
COV_MODE_LENGTH_SHORTER = 5

SEQ_ID_ALN_LEN = 0
SEQ_ID_SHORT = 1
SEQ_ID_LONG = 2


def has_coverage(cov_thr, cov_mode, qcov, tcov):
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return qcov >= cov_thr and tcov >= cov_thr
    if cov_mode == COV_MODE_QUERY:
        return qcov >= cov_thr
    if cov_mode == COV_MODE_TARGET:
        return tcov >= cov_thr
    return True


def can_be_covered(cov_thr, cov_mode, qlen, tlen):
    qlen, tlen = float(qlen), float(tlen)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return qlen / tlen >= cov_thr and tlen / qlen >= cov_thr
    if cov_mode == COV_MODE_QUERY:
        return tlen / qlen >= cov_thr
    if cov_mode == COV_MODE_TARGET:
        return qlen / tlen >= cov_thr
    if cov_mode == COV_MODE_LENGTH_QUERY:
        return cov_thr <= tlen / qlen <= 1.0
    if cov_mode == COV_MODE_LENGTH_TARGET:
        return cov_thr <= qlen / tlen <= 1.0
    if cov_mode == COV_MODE_LENGTH_SHORTER:
        return min(qlen, tlen) / max(qlen, tlen) >= cov_thr
    return True


def compute_cov(start, end, length):
    return np.float32(end - start + 1) / np.float32(length)


def compute_seq_id(mode, aa_ids, qlen, tlen, aln_len):
    if mode == SEQ_ID_SHORT:
        return np.float32(aa_ids) / np.float32(min(qlen, tlen))
    if mode == SEQ_ID_LONG:
        return np.float32(aa_ids) / np.float32(max(qlen, tlen))
    if mode == SEQ_ID_ALN_LEN:
        return np.float32(aa_ids) / np.float32(aln_len)
    return np.float32(0.0)


def estimate_seq_id_by_score_per_col(score, qlen, tlen):
    # Matcher::estimateSeqIdByScorePerCol: float division, then DOUBLE
    # 0.1656/0.1141 literals — the product/sum run in double before the
    # final narrowing back to float
    ratio = np.float32(score) / np.float32(max(qlen, tlen))
    est = np.float32(np.float64(ratio) * 0.1656 + 0.1141)
    est = min(est, np.float32(1.0))
    return float(max(np.float32(0.0), est))


def fast_seq_id_str(seq_id) -> str:
    """fastSeqIdToBuffer, as it appears after resultToBuffer overwrites the
    char before the returned pointer with a tab."""
    s = np.float32(seq_id)
    if s == 1.0:
        return "1.00"   # reference off-by-one: '1.000' minus the last digit
    out = "0."
    if s < 0.10:
        out += "0"
    if s < 0.01:
        out += "0"
    return out + str(int(s * np.float32(1000)))


def format_evalue(e) -> str:
    return f"{e:.3E}"


def compress_backtrace(bt: str) -> str:
    """Matcher::compressAlignment: run-length 'cigar' (e.g. 57M, 10M2I5M)."""
    out = []
    i = 0
    n = len(bt)
    while i < n:
        j = i
        while j < n and bt[j] == bt[i]:
            j += 1
        out.append(f"{j - i}{bt[i]}")
        i = j
    return "".join(out)


def result_to_line(res, add_backtrace: bool) -> str:
    """Matcher::resultToBuffer 10/11-column alignment record (no ORF cols)."""
    parts = [
        str(res.db_key), str(res.score), fast_seq_id_str(res.seq_id),
        format_evalue(res.eval), str(res.q_start), str(res.q_end),
        str(res.q_len), str(res.db_start), str(res.db_end), str(res.db_len),
    ]
    if add_backtrace:
        parts.append(compress_backtrace(res.backtrace))
    return "\t".join(parts) + "\n"


def rescore_backtrace(q_seq, t_seq, enc, sub_matrix, evaluer,
                      gap_open, gap_ext, res):
    """Port of Matcher::updateResultByRescoringBacktrace
    (Matcher.cpp:331-399): local rescan over the backtrace; gap-open is
    charged once per gap run and NOT reset between adjacent I and D runs.
    `q_seq`/`t_seq` are byte strings, `enc` a 256-entry byte->index table."""
    max_score = max_bt_end = max_bt_start = 0
    max_q_end = max_q_start = max_t_start = max_t_end = 0
    min_pos = -1
    min_q_pos = res.q_start - 1
    min_t_pos = res.db_start - 1
    score = 0
    identical = 0
    max_id_cnt = 0
    q_pos, t_pos = res.q_start, res.db_start
    gap_open_flag = False
    bt = res.backtrace
    for pos, letter in enumerate(bt):
        if letter == "M":
            qc, tc = q_seq[q_pos], t_seq[t_pos]
            score += int(sub_matrix[enc[qc]][enc[tc]])
            identical += int(qc == tc)
            gap_open_flag = False
        else:
            score -= gap_ext if gap_open_flag else gap_open
            gap_open_flag = True
        if score <= 0:
            score = 0
            identical = 0
            min_pos = pos
            min_q_pos = q_pos - 1 if letter == "D" else q_pos
            min_t_pos = t_pos - 1 if letter == "I" else t_pos
        if score > max_score:
            max_bt_end, max_q_end, max_t_end = pos, q_pos, t_pos
            max_bt_start = min_pos + 1
            max_q_start, max_t_start = min_q_pos + 1, min_t_pos + 1
            max_score = score
            max_id_cnt = identical
        if letter in "MI":
            q_pos += 1
        if letter in "MD":
            t_pos += 1
    import numpy as np
    res.q_start, res.q_end = max_q_start, max_q_end
    res.db_start, res.db_end = max_t_start, max_t_end
    res.score = int(evaluer.compute_bit_score(max_score))
    res.eval = evaluer.compute_evalue(max_score, res.q_len)
    res.aln_length = max_bt_end - max_bt_start + 1
    res.seq_id = max_id_cnt / np.float32(res.aln_length) \
        if res.aln_length else 0.0
    res.backtrace = bt[max_bt_start:max_bt_start + res.aln_length]
    return res
