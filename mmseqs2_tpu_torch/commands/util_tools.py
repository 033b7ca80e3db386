"""Alignment-record helpers of the result/DB utility commands.

Port of mmseqs2_tpu/commands/util_tools.py, of which this slice needs the
alignment-line parser and writer that `swapresults` (db_tools.py) uses. The
commands of that module (swapdb, sortresult, summarizeresult, ...) are not
yet ported (see ROADMAP.md).
"""

import numpy as np

from ..align import util as autil
from .common import fast_atoi


def _aln_parse(line: bytes):
    """Matcher::parseAlignmentRecord(readCompressed=true): backtrace is
    expanded; coverage recomputed from the positions."""
    p = line.split(b"\t")
    r = {
        "dbKey": fast_atoi(p[0]), "score": int(p[1]),
        "seqId": np.float32(float(p[2])), "eval": float(p[3]),
        "qStart": int(p[4]), "qEnd": int(p[5]), "qLen": int(p[6]),
        "dbStart": int(p[7]), "dbEnd": int(p[8]), "dbLen": int(p[9]),
        "backtrace": "",
    }
    if len(p) == 11 or len(p) >= 15:
        # readCompressed=true keeps the cigar compressed (parseAlignmentRecord)
        r["backtrace"] = p[10 if len(p) == 11 else 14].decode()
    aq = 0 if r["qStart"] == -1 else r["qStart"]
    ad = 0 if r["dbStart"] == -1 else r["dbStart"]
    r["qCov"] = autil.compute_cov(aq, r["qEnd"], r["qLen"])
    r["dbCov"] = autil.compute_cov(ad, r["dbEnd"], r["dbLen"])
    return r


def _aln_to_line(r, add_backtrace: bool) -> str:
    cols = [str(r["dbKey"]), str(r["score"]),
            autil.fast_seq_id_str(r["seqId"]),
            autil.format_evalue(r["eval"]),
            str(r["qStart"]), str(r["qEnd"]), str(r["qLen"]),
            str(r["dbStart"]), str(r["dbEnd"]), str(r["dbLen"])]
    if add_backtrace:
        cols.append(r["backtrace"])
    return "\t".join(cols) + "\n"
