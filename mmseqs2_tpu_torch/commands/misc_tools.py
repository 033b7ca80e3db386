"""`clusthash`: group sequences by a reduced-alphabet hash.

Port of mmseqs2_tpu/commands/misc_tools.py, of which this slice needs the
one command that the linclust workflow calls (--clust-hash). Reference
src/util/clusthash.cpp. A nucleotide DB hashes each sequence and its
reverse complement and keeps the smaller hash.
"""

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from .nucl_tools import COMPLEMENT

U64 = (1 << 64) - 1


def clusthash(par, command):
    """Group sequences by reduced-alphabet hash; within each hash bucket link
    equal-length sequences with Hamming identity >= --min-seq-id
    (reference src/util/clusthash.cpp). Output is an alignment-result DB."""
    from ..align.util import fast_seq_id_str
    from ..data.reduced import get_reduced

    def seq_id_raw(s):
        # raw fastSeqIdToBuffer (Util.cpp:251-263): '1.000' at identity —
        # unlike the alignment path, no trailing char is overwritten here
        return "1.000" if np.float32(s) == 1.0 else fast_seq_id_str(s)

    db, out = par.filenames[:2]
    seq_id_thr = par.min_seq_id if par.was_set("min_seq_id") else 0.99
    alph = (par.alph_size.aa if par.was_set("alph_size") else 3)
    r = DBReader(db)
    is_nucl = r.base_type == dbt.DBTYPE_NUCLEOTIDES
    n = r.size
    hashes = np.empty(n, dtype=np.uint64)
    if is_nucl:
        for i in range(n):
            seq = r.get_seq(i)
            h1 = h2 = 0
            rc = seq[::-1].translate(COMPLEMENT)
            for b1, b2 in zip(seq, rc):
                h1 = (h1 * 31 + b1) & U64
                h2 = (h2 * 31 + b2) & U64
            hashes[i] = min(h1, h2)
    else:
        red = get_reduced(par.sub_mat.aa, alph)
        table = red.make_aa2num_table()
        for i in range(n):
            num = table[np.frombuffer(r.get_seq(i), np.uint8)]
            h = 0
            for v in num:
                h = (h * 31 + int(v)) & U64
            hashes[i] = h
    order = sorted(range(n), key=lambda i: (int(hashes[i]), i))
    with DBWriter(out, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed)) as w:
        start = 0
        while start < n:
            stop = start
            while stop < n and hashes[order[stop]] == hashes[order[start]]:
                stop += 1
            ids = order[start:stop]
            found = [False] * len(ids)
            for a in range(len(ids)):
                qkey = r.get_db_key(ids[a])
                qlen = r.get_seq_len(ids[a])
                qseq = r.get_seq(ids[a])
                lines = [f"{qkey}\t255\t1.00\t0\t0\t{qlen - 1}\t{qlen}"
                         f"\t0\t{qlen - 1}\t{qlen}\n"]
                if not found[a]:
                    for b in range(len(ids)):
                        if found[b] or a == b:
                            continue
                        if r.get_seq_len(ids[b]) != qlen:
                            continue
                        tseq = r.get_seq(ids[b])
                        same = sum(x == y for x, y in zip(qseq, tseq))
                        seq_id = np.float32(same) / np.float32(qlen)
                        if seq_id >= seq_id_thr:
                            lines.append(
                                f"{r.get_db_key(ids[b])}\t255\t"
                                f"{seq_id_raw(seq_id)}\t0\t0\t"
                                f"{qlen - 1}\t{qlen}\t0\t{qlen - 1}\t"
                                f"{qlen}\n")
                            found[b] = True
                w.write(qkey, "".join(lines).encode())
            start = stop
    r.close()
    return 0
