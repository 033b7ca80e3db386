"""Clustering helper commands: mergeclusters, result2repseq, createseqfiledb,
filterdb (subset used by the clustering workflows).

Reference: src/util/mergeclusters.cpp, result2repseq.cpp, createseqfiledb.cpp,
filterdb.cpp.
"""

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from .common import fast_atoi


def mergeclusters(par, command):
    """Compose cascaded clustering steps (mergeclusters.cpp): the first
    clustering seeds per-sequence member lists; each later step splices the
    lists of its members into its representative's list."""
    seq_path, out_path = par.filenames[0], par.filenames[1]
    clusterings = par.filenames[2:]
    seq = DBReader(seq_path)
    key_to_id = {int(k): i for i, k in enumerate(seq.keys)}
    merged = [[] for _ in range(seq.size)]

    first = DBReader(clusterings[0])
    for i in range(first.size):
        clu_id = key_to_id[first.get_db_key(i)]
        for line in first.get_data(i).split(b"\n"):
            if line:
                merged[clu_id].append(key_to_id[fast_atoi(line)])
    first.close()

    for path in clusterings[1:]:
        clu = DBReader(path)
        for i in range(clu.size):
            clu_id = key_to_id[clu.get_db_key(i)]
            for line in clu.get_data(i).split(b"\n"):
                if not line:
                    continue
                seq_id = key_to_id[fast_atoi(line)]
                if seq_id != clu_id:
                    merged[clu_id].extend(merged[seq_id])
                    merged[seq_id] = []
        clu.close()

    with DBWriter(out_path, dbt.DBTYPE_CLUSTER_RES) as w:
        for i in range(seq.size):
            if not merged[i]:
                continue
            data = "".join(f"{int(seq.keys[m])}\n" for m in merged[i])
            w.write(seq.get_db_key(i), data.encode())
    seq.close()
    return 0


def result2repseq(par, command):
    """Extract representative sequences of a result DB (result2repseq.cpp)."""
    seq_path, res_path, out_path = par.filenames[:3]
    seq = DBReader(seq_path)
    res = DBReader(res_path)
    with DBWriter(out_path, seq.base_type, seq.extended_type) as w:
        for i in range(res.size):
            key = res.get_db_key(i)
            sid = seq.get_id(key)
            if sid >= 0:
                w.write(key, seq.get_data(sid))
    seq.close()
    res.close()
    return 0


def createseqfiledb(par, command):
    """Per-cluster FASTA files as a DB (createseqfiledb.cpp):
    --min-sequences/--max-sequences bound the cluster sizes written;
    --hh-format renders singleton clusters as hhsuite a3m stubs
    (#header, _consensus copy, then the member)."""
    seq_path, clu_path, out_path = par.filenames[:3]
    seq = DBReader(seq_path)
    hdr = DBReader(seq_path + "_h")
    clu = DBReader(clu_path)
    with DBWriter(out_path, dbt.DBTYPE_GENERIC_DB) as w:
        for i in range(clu.size):
            keys = [fast_atoi(line) for line in clu.get_data(i).split(b"\n")
                    if line]
            if len(keys) < par.min_sequences \
                    or len(keys) > par.max_sequences:
                continue
            parts = []
            for n, key in enumerate(keys):
                header = hdr.get_data(hdr.get_id(key))
                body = seq.get_data(seq.get_id(key))
                if n == 0 and par.hh_format:
                    # hhsuite a3m stub for the cluster head
                    # (createseqfiledb.cpp:73-87)
                    accession = header.split()[0] if header.strip() else b""
                    parts.append(b"#" + header)
                    parts.append(b">" + accession + b"_consensus\n")
                    parts.append(body)
                    parts.append(b">" + header)
                    parts.append(body)
                else:
                    parts.append(b">" + header)
                    parts.append(body)
            w.write(clu.get_db_key(i), b"".join(parts))
    for r in (seq, hdr, clu):
        r.close()
    return 0


def filterdb(par, command):
    """filterdb subset: --filter-file membership on the first column
    (filterdb.cpp FILE_FILTERING mode; the full expression/regex/column
    machinery follows with the util-command long tail)."""
    in_path, out_path = par.filenames[:2]
    res = DBReader(in_path)
    keep = None
    if par.filter_file:
        with open(par.filter_file) as f:
            keep = set(line.split()[0].encode() for line in f if line.strip())
    col = par.filter_column - 1
    op = par.comparison_operator
    with DBWriter(out_path, res.base_type, res.extended_type) as w:
        for i in range(res.size):
            data = res.get_data(i)
            lines = [ln for ln in data.split(b"\n") if ln]
            if keep is not None:
                lines = [ln for ln in lines
                         if ln.split(b"\t")[0].split()[0] in keep]
            elif par.beats_first:
                # BEATS_FIRST (filterdb.cpp:400-420): line 1 sets the
                # reference; keep lines whose column beats it
                kept = []
                ref = None
                for ln in lines:
                    cols = ln.split(b"\t")
                    if ref is None:
                        ref = float(cols[col])
                        kept.append(ln)
                        continue
                    v = float(cols[col])
                    ok = {"ge": v >= ref, "le": v <= ref,
                          "e": v == ref}.get(op, True)
                    if ok:
                        kept.append(ln)
                lines = kept
            data = b"".join(ln + b"\n" for ln in lines)
            w.write(res.get_db_key(i), data)
    res.close()
    return 0
