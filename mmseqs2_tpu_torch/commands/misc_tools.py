"""Assorted utility commands: `clusthash` (group sequences by a
reduced-alphabet hash), `recoverlongestorf` and `diffseqdbs`.

Port of mmseqs2_tpu/commands/misc_tools.py, of which the port needs the
command that the linclust workflow calls (--clust-hash), the one that the
taxonomy workflow's contig route calls (recoverlongestorf), the one that
clusterupdate calls (diffseqdbs), and the UniProt header summary of
`result2msa --msa-format-mode 3` (_uniprot_summarize). Reference
src/util/clusthash.cpp, recoverlongestorf.cpp, diffseqdbs.cpp and
summarizeheaders.cpp. A nucleotide DB hashes each
sequence and its reverse complement and keeps the smaller hash.
"""

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from .nucl_tools import COMPLEMENT, parse_orf_header

U64 = (1 << 64) - 1


_UNINFORMATIVE = ("hypothetical", "unknown", "putative", "predicted",
                  "unnamed", "probable", "partial", "possible",
                  "uncharacterized", "fragment")


def _libstdcxx_make_heap(a, less):
    """Reproduce libstdc++ std::make_heap element layout (the reference
    iterates the heapified vector in storage order, so layout matters)."""
    n = len(a)
    if n < 2:
        return
    parent = (n - 2) // 2
    while True:
        value = a[parent]
        # __adjust_heap
        hole = parent
        second = hole
        while second < (n - 1) // 2:
            second = 2 * (second + 1)
            if less(a[second], a[second - 1]):
                second -= 1
            a[hole] = a[second]
            hole = second
        if n % 2 == 0 and second == (n - 2) // 2:
            second = 2 * (second + 1)
            a[hole] = a[second - 1]
            hole = second - 1
        # __push_heap
        top = parent
        while hole > top and less(a[(hole - 1) // 2], value):
            a[hole] = a[(hole - 1) // 2]
            hole = (hole - 1) // 2
        a[hole] = value
        if parent == 0:
            return
        parent -= 1


def _uniprot_summarize(headers):
    queue = []  # (priority, identifier, proteinName)
    rep = ""
    for hi, header in enumerate(headers):
        end = header.find("|")
        if end < 0:
            continue
        db_type = header[:end]
        start = end + 1
        end = header.find("|", start)
        if end < 0:
            continue
        ident = header[start:end]
        if hi == 0:
            rep = ident
        start = header.find(" ", end)
        if start < 0:
            continue
        start += 1
        end = header.find(" OS=", start)
        if end < 0:
            continue
        protein = header[start:end]
        start = header.find("=", end)
        if start < 0:
            continue
        end2 = header.find(" GN=", start + 1)
        if end2 < 0:
            end2 = header.find(" PE=", start + 1)
            if end2 < 0:
                continue
        start = header.find("PE=", end2)
        if start < 0:
            continue
        start += 3
        end2 = header.find(" SV=", start)
        if end2 < 0:
            continue
        try:
            existence = int(header[start:end2])
        except ValueError:
            existence = 0
        priority = 0
        if not any(u in ident for u in _UNINFORMATIVE):
            if db_type == "sp":
                priority = 4
            elif db_type == "tr":
                priority = 1
            # unsigned arithmetic: min(existence,5) - 5 wraps for < 5
            priority = (priority + (min(existence, 5) - 5)) & 0xFFFFFFFF
        queue.append([priority, ident, protein])
    _libstdcxx_make_heap(queue, lambda x, y: x[0] < y[0])
    parts = [f"Representative={rep} n={len(headers)} Descriptions=["]
    used = set()
    cnt = 0
    for i, (_, ident, protein) in enumerate(queue):
        if cnt > 5:
            break
        if protein in used:
            continue
        parts.append(protein)
        used.add(protein)
        cnt += 1
        if i != len(queue) - 1 and cnt <= 5:
            parts.append("|")
    parts.append("] Members=")
    for i, (_, ident, _p) in enumerate(queue):
        parts.append(ident)
        if i != len(queue) - 1:
            parts.append(",")
    return "".join(parts) + "\n"


def recoverlongestorf(par, command):
    """From an ORF search result, emit the longest ORF key of every contig
    whose ORFs all missed (reference src/util/recoverlongestorf.cpp).
    Output is a headerless flat file of ORF keys."""
    orfdb, resdb, out = par.filenames[:3]
    hdr = DBReader(orfdb + "_h")
    contig_longest = {}  # contig -> (orfKey, orfLen)
    orf_contig = {}
    for i in range(hdr.size):
        orf_key = hdr.get_db_key(i)
        loc = parse_orf_header(hdr.get_data(i))
        if loc is None:
            continue
        contig, frm, to = loc[0], loc[1], loc[2]
        orf_len = abs(frm - to) + 1
        orf_contig[orf_key] = contig
        cur = contig_longest.get(contig)
        if cur is None or orf_len > cur[1]:
            contig_longest[contig] = (orf_key, orf_len)
    hdr.close()
    accepted, eliminated = set(), set()
    with DBReader(resdb) as r:
        for i in range(r.size):
            key = r.get_db_key(i)
            contig = orf_contig.get(key)
            if contig is None:
                continue
            if r.get_entry_len(i) > 1:
                accepted.add(contig)
            eliminated.add(contig)
    with open(out, "w") as f:
        for contig in eliminated - accepted:
            f.write(f"{contig_longest[contig][0]}\n")
    dbt.write_dbtype(out, dbt.DBTYPE_OMIT_FILE)
    return 0


def diffseqdbs(par, command):
    """Diff two sequence DBs by header: emit removed / kept(mapped) / new
    key files (reference src/util/diffseqdbs.cpp)."""
    from ..db.fasta import parse_fasta_header

    old_db, new_db, removed_f, kept_f, new_f = par.filenames[:5]
    use_seq_id = bool(par.use_seq_id) if par.was_set("use_seq_id") else False

    def read_keys(db):
        out = []
        with DBReader(db + "_h") as r:
            for i in range(r.size):
                h = r.get_data(i)
                if use_seq_id:
                    name = parse_fasta_header(h).decode()
                else:
                    name = "".join(h.decode(errors="replace").split())
                out.append((name, r.get_db_key(i)))
        return out

    keys_old = read_keys(old_db)
    keys_new = read_keys(new_db)
    keys_new.sort(key=lambda p: p[0])
    # duplicate headers in new DB are invalidated
    invalid_new = [False] * len(keys_new)
    for i in range(len(keys_new) - 1):
        if keys_new[i][0] == keys_new[i + 1][0]:
            invalid_new[i + 1] = True
    # duplicate headers in old DB are deleted
    deleted = [False] * len(keys_old)
    order = sorted(range(len(keys_old)), key=lambda i: keys_old[i][0])
    for a, b in zip(order, order[1:]):
        if keys_old[a][0] == keys_old[b][0]:
            deleted[b] = True
    names_new = [p[0] for p in keys_new]
    checked = [False] * len(keys_new)
    mapped = [0] * len(keys_new)
    import bisect
    for i, (name, _key) in enumerate(keys_old):
        if deleted[i]:
            continue
        j = bisect.bisect_left(names_new, name)
        if j < len(keys_new) and names_new[j] == name:
            checked[j] = True
            mapped[j] = i
        else:
            deleted[i] = True
    with open(kept_f, "w") as kf, open(new_f, "w") as nf:
        for j in range(len(keys_new)):
            if invalid_new[j]:
                continue
            if checked[j]:
                kf.write(f"{keys_old[mapped[j]][1]}\t{keys_new[j][1]}\n")
            else:
                nf.write(f"{keys_new[j][1]}\n")
    with open(removed_f, "w") as rf:
        for i in range(len(keys_old)):
            if deleted[i]:
                rf.write(f"{keys_old[i][1]}\n")
    return 0


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
