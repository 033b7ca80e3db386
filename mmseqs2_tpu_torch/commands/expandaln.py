"""Alignment records of `expandaln`.

Port of mmseqs2_tpu/commands/expandaln.py, of which this slice needs only
the alignment record `Rec` that `filterresult` (result2profile.py) parses
and writes. The commands of that module (`expandaln`, `expand2profile`) are
not yet ported (see ROADMAP.md).
"""

from ..align import util as autil
from .convertalis import expand_cigar


class Rec:
    __slots__ = ("db_key", "score", "seq_id", "eval", "q_start", "q_end",
                 "q_len", "db_start", "db_end", "db_len", "backtrace",
                 "qcov", "dbcov", "aln_length", "raw_score")

    @classmethod
    def parse(cls, parts):
        r = cls()
        r.db_key = int(parts[0])
        r.score = int(parts[1])
        r.seq_id = float(parts[2])
        r.eval = float(parts[3])
        r.q_start = int(parts[4])
        r.q_end = int(parts[5])
        r.q_len = int(parts[6])
        r.db_start = int(parts[7])
        r.db_end = int(parts[8])
        r.db_len = int(parts[9])
        r.backtrace = expand_cigar(parts[10].decode()) \
            if len(parts) > 10 else ""
        r.aln_length = len(r.backtrace)
        r.qcov = autil.compute_cov(r.q_start, r.q_end, r.q_len)
        r.dbcov = autil.compute_cov(r.db_start, r.db_end, r.db_len)
        return r

    def to_line(self, add_backtrace=True):
        return autil.result_to_line(self, add_backtrace)
