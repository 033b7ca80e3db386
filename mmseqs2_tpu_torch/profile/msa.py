"""Center-star MSA from alignment backtraces.

Port of mmseqs2_tpu/profile/msa.py: the noDeletion MSA of the profile path
and the allowDeletion MSA of `result2msa --allow-deletion`.
Reference: src/alignment/MultipleAlignment.cpp. Rows are numeric letters with
GAP=21 (ANY=20 is X); the profile path uses noDeletionMSA=true, where target
insertions (D) are dropped so the MSA width equals the center length.
"""

import numpy as np

NAA = 20
ANY = 20
GAP = 21
ENDGAP = 22


def compute_msa_nodel(center_num: np.ndarray, edge_seqs, aln_results):
    """noDeletionMSA center-star MSA: (setSize, centerLen) numeric rows.

    aln_results: list of objects with q_start, q_end, db_start, backtrace
    (expanded 'M'/'I'/'D' string).
    """
    L = len(center_num)
    n = len(edge_seqs) + 1
    msa = np.full((n, L), GAP, dtype=np.uint8)
    msa[0, :] = center_num
    for r, (seq, res) in enumerate(zip(edge_seqs, aln_results), start=1):
        qpos = res.q_start
        tpos = res.db_start
        row = msa[r]
        for op in res.backtrace:
            if op == 'M':
                row[qpos] = seq[tpos]
                qpos += 1
                tpos += 1
            elif op == 'I':
                row[qpos] = GAP
                qpos += 1
            else:                       # 'D': dropped in noDeletion mode
                tpos += 1
    return msa


def compute_msa_del(center_num: np.ndarray, edge_seqs, aln_results):
    """allowDeletion (noDeletionMSA=false) center-star MSA
    (MultipleAlignment.cpp:46-198): per-position query gap columns are
    inserted for the longest deletion run observed at that position; edge
    rows write their deleted target letters inline.  Reference quirks kept:
    the leading gap fill of an edge row ignores earlier gap columns, and an
    M directly following a deletion run skips the gap-column insertion.
    Rows are wider than the center length; result2msa emission reads only
    the first centerLength columns (result2msa.cpp:312 etc.)."""
    L = len(center_num)
    gaps = np.zeros(L + 1, dtype=np.int64)
    for res in aln_results:
        run = 0
        qp = res.q_start
        for op in res.backtrace:
            if op == 'D':
                run += 1
                if run > gaps[qp]:
                    gaps[qp] = run
            else:
                qp += 1
                run = 0
    width = int(L + gaps.sum()
                + max((len(r.backtrace) for r in aln_results), default=0)
                + L)
    n = len(edge_seqs) + 1
    msa = np.full((n, width), GAP, dtype=np.uint8)
    pos = 0
    for qp in range(L):
        pos += int(gaps[qp])
        msa[0, pos] = center_num[qp]
        pos += 1
    for r, (seq, res) in enumerate(zip(edge_seqs, aln_results), start=1):
        row = msa[r]
        qp = res.q_start
        tp = res.db_start
        buf = qp                   # leading '-' fill (no gap columns)
        bt = res.backtrace
        i = 0
        nbt = len(bt)
        while i < nbt:
            op = bt[i]
            if op == 'I':
                buf += 1           # '-' (already GAP)
                qp += 1
                i += 1
            elif op == 'D':
                while i < nbt and bt[i] == 'D':
                    row[buf] = seq[tp]
                    buf += 1
                    tp += 1
                    i += 1
                if i >= nbt:
                    break
                if bt[i] == 'I':
                    buf += 1
                    qp += 1
                    i += 1
                elif bt[i] == 'M':
                    row[buf] = seq[tp]
                    buf += 1
                    qp += 1
                    tp += 1
                    i += 1
            else:                  # 'M': insert pending gap columns first
                buf += int(gaps[qp])
                row[buf] = seq[tp]
                buf += 1
                qp += 1
                tp += 1
                i += 1
    return msa
