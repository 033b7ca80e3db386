"""Multihit subsystem, the two commands that the port needs so far:
`mergeresultsbyset` (src/util/mergeresultsbyset.cpp), which the taxonomy
workflow's contig route calls, and `tsv2db` (src/util/tsv2db.cpp), which
cluster --cluster-reassign calls.

Port of mmseqs2_tpu/commands/multihit.py (host code). Its other commands
(besthitperset, combinepvalperset, result2stats) are not yet ported (see
ROADMAP.md).
"""

from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from .common import fast_atoi


def mergeresultsbyset(par, command):
    """Concatenate per-member result entries into per-set entries
    (src/util/mergeresultsbyset.cpp)."""
    set_path, result_path, out_path = par.filenames[:3]
    sets = DBReader(set_path)
    res = DBReader(result_path)
    writer = DBWriter(out_path, res.base_type, res.extended_type)
    for i in range(sets.size):
        buf = []
        for line in sets.get_data(i).split(b"\n"):
            if not line:
                continue
            key = fast_atoi(line.split()[0])
            rid = res.get_id(key)
            if rid < 0:
                log.die(f"Missing result entry {key}")
            buf.append(res.get_data(rid))
        writer.write(sets.get_db_key(i), b"".join(buf))
    writer.close()
    return 0


def tsv2db(par, command):
    """TSV (key \\t value) -> DB; consecutive identical first columns merge
    into one entry (src/util/tsv2db.cpp)."""
    tsv_path, out_path = par.filenames[:2]
    writer = DBWriter(out_path, par.output_dbtype)
    cur_key = None
    buf = []
    with open(tsv_path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if not line:
                continue
            key_s, _, rest = line.partition(b"\t")
            key = fast_atoi(key_s)
            if cur_key is not None and key != cur_key:
                writer.write(cur_key, b"".join(buf))
                buf = []
            cur_key = key
            buf.append(rest + b"\n")
    if cur_key is not None:
        writer.write(cur_key, b"".join(buf))
    writer.close()
    return 0
