"""Center-star MSA from alignment backtraces.

Port of mmseqs2_tpu/profile/msa.py without compute_msa_del (the
allowDeletion MSA of the MSA tools, not yet ported; see ROADMAP.md).
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
