"""Result/DB utility commands: result2flat, convert2fasta, prefixid,
suffixid, reverseseq, sortresult, summarizeresult, splitdb, renamedbkeys,
masksequence, orftocontig, aliasdb, swapdb, summarizealis, and the
alignment-line helpers that `swapresults` (db_tools.py) uses.

Port of mmseqs2_tpu/commands/util_tools.py (host code). Reference: the
matching single-purpose tools in src/util/. masksequence runs tantan over
MASK_CHUNK sequences per call.
"""

import os

import numpy as np

from ..align import util as autil
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from .common import fast_atoi
PROFILE_READIN_SIZE = 25


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


def _parse_fasta_accession(header: bytes) -> str:
    from .convertalis import parse_fasta_header
    return parse_fasta_header(header.split(b"\n")[0].decode())


def result2flat(par, command):
    """Flat FASTA-like file: query header, then each result line prefixed by
    the target accession (result2flat.cpp)."""
    qdb, tdb, res_path, out_path = par.filenames[:4]
    qh = DBReader(qdb + "_h")
    th = qh if qdb == tdb else DBReader(tdb + "_h")
    res = DBReader(res_path)
    is_result = res.base_type in (dbt.DBTYPE_ALIGNMENT_RES,
                                  dbt.DBTYPE_PREFILTER_RES,
                                  dbt.DBTYPE_CLUSTER_RES)
    with open(out_path, "w") as f:
        order = np.argsort(res.offsets, kind="stable")
        for i in order:
            key = res.get_db_key(int(i))
            header = qh.get_data(qh.get_id(key))
            if par.use_header:
                line = header.split(b"\n")[0].decode()
                f.write(">" + line + " \n")
            else:
                f.write(">" + _parse_fasta_accession(header) + "\n")
            for line in res.get_data(int(i)).split(b"\n"):
                if not line:
                    continue
                out = line.decode()
                if is_result:
                    t_key = fast_atoi(line.split(b"\t")[0])
                    t_header = th.get_data(th.get_id(t_key))
                    if par.use_header:
                        key_len = len(line.split(b"\t")[0])
                        out = (_parse_fasta_accession(t_header)
                               + out[key_len:])
                f.write(out + "\n")
    return 0


def convert2fasta(par, command):
    """Sequence DB -> FASTA (convert2fasta.cpp); --use-header-file iterates
    the header DB's entry order instead of the body's."""
    in_path, out_path = par.filenames[:2]
    db = DBReader(in_path)
    dbh = DBReader(in_path + "_h")
    src = dbh if par.use_header_file else db
    with open(out_path, "w") as f:
        for i in range(src.size):
            key = src.get_db_key(i)
            header = dbh.get_data(dbh.get_id(key))[:-1]
            body = db.get_data(db.get_id(key))[:-1]
            f.write(">" + header.decode())
            f.write("\n")
            f.write(body.decode())
            f.write("\n")
    return 0


def _fixid(par, command, is_prefix: bool):
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    tsv = par.tsv_out
    order = np.argsort(reader.offsets, kind="stable")
    w = None if tsv else DBWriter(out_path, reader.base_type,
                                  reader.extended_type)
    flat = open(out_path, "w") if tsv else None
    for i in order:
        key = reader.get_db_key(int(i))
        add = par.mapping_prefix if par.mapping_prefix else str(key)
        out = []
        for line in reader.get_data(int(i)).split(b"\n"):
            if not line:
                continue
            if is_prefix:
                out.append(f"{add}\t{line.decode()}\n")
            else:
                out.append(f"{line.decode()}\t{add}\n")
        if tsv:
            flat.write("".join(out))
        else:
            w.write(key, "".join(out).encode())
    if tsv:
        flat.close()
    else:
        w.close()
    return 0


def prefixid(par, command):
    """Prepend the entry key (or a fixed string) to every line."""
    return _fixid(par, command, True)


def suffixid(par, command):
    return _fixid(par, command, False)


def reverseseq(par, command):
    """Reverse sequences (or profile positions) per entry."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    is_profile = reader.base_type == dbt.DBTYPE_HMM_PROFILE
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            if is_profile:
                data = reader.get_data(int(i))
                L = len(data) // PROFILE_READIN_SIZE
                arr = np.frombuffer(data[:L * PROFILE_READIN_SIZE],
                                    dtype=np.uint8)
                rev = arr.reshape(L, PROFILE_READIN_SIZE)[::-1].tobytes()
                w.write(key, rev)
            else:
                seq = reader.get_seq(int(i))
                w.write(key, seq[::-1] + b"\n")
    # header/auxiliary files stay those of the input
    for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source"):
        src, dst = in_path + suf, out_path + suf
        if os.path.exists(src) and not os.path.lexists(dst):
            os.symlink(os.path.abspath(src), dst)
    return 0


def sortresult(par, command):
    """Sort alignment entries by Matcher::compareHits / prefilter entries by
    score (sortresult.cpp); backtraces are re-emitted expanded."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            alns, prefs = [], []
            fmt = -1
            for line in reader.get_data(int(i)).split(b"\n"):
                if not line:
                    continue
                cols = line.split(b"\t")
                if len(cols) >= 10:
                    alns.append(_aln_parse(line))
                    fmt = 1 if len(cols) >= 11 else 0
                elif len(cols) == 3:
                    prefs.append((fast_atoi(cols[0]), int(cols[1]),
                                  int(cols[2])))
                    fmt = 2
                else:
                    log.die(f"Invalid input result format "
                            f"({len(cols)} columns).")
            out = []
            if fmt in (0, 1):
                alns.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                         r["dbKey"]))
                out = [_aln_to_line(r, fmt == 1) for r in alns]
            elif fmt == 2:
                prefs.sort(key=lambda h: (-abs(h[1]), h[0]))
                out = [f"{k}\t{s}\t{d}\n" for k, s, d in prefs]
            w.write(key, "".join(out).encode())
    return 0


def summarizeresult(par, command):
    """Greedy non-overlapping domain selection over each entry
    (summarizeresult.cpp)."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            covered = None
            out = []
            for line in reader.get_data(int(i)).split(b"\n"):
                if not line:
                    continue
                d = _aln_parse(line)
                if covered is None:
                    covered = np.zeros(d["qLen"], dtype=bool)
                if d["qStart"] > d["qLen"] or d["qEnd"] > d["qLen"]:
                    log.warning("Query alignment start or end is greater "
                                "than query length! Skipping line.")
                    continue
                if d["dbCov"] < par.cov_thr:
                    continue
                lo = min(d["qStart"], d["qEnd"])
                hi = max(d["qStart"], d["qEnd"])
                counter = int(covered[lo:hi].sum())
                overlap = np.float32(counter) / np.float32(hi - lo + 1)
                if overlap <= np.float32(par.overlap):
                    covered[lo:hi] = True
                    out.append(_aln_to_line(d, par.add_backtrace))
            w.write(key, "".join(out).encode())
    return 0


def splitdb(par, command):
    """Split a DB into --split chunks (splitdb.cpp naming:
    out_<i>_<n>)."""
    in_path, out_base = par.filenames[:2]
    reader = DBReader(in_path)
    n = par.split
    if n < 1:
        log.die("Cannot split databases into 0 or negative chunks.")
    if n > reader.size:
        log.die("Cannot split databases into more chunks than database "
                "contains.")
    for split in range(n):
        out = f"{out_base}_{split}_{n}"
        # Util::decomposeDomain: equal chunks, remainder to the LAST split
        start = reader.size // n * split
        count = reader.size // n + (reader.size % n if split == n - 1
                                    else 0)
        with DBWriter(out, reader.base_type, reader.extended_type) as w:
            for i in range(start, start + count):
                w.write(reader.get_db_key(i), reader.get_data(i))
        for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source"):
            src, dst = in_path + suf, out + suf
            if os.path.exists(src) and not os.path.lexists(dst):
                os.symlink(os.path.abspath(src), dst)
    return 0


def renamedbkeys(par, command):
    """Rename DB keys from a two-column mapping file (renamedbkeys.cpp);
    a sibling _h header DB is renamed alongside
    (renamedbkeys.cpp:76-139)."""
    map_path, in_path, out_path = par.filenames[:3]
    pairs = []
    for line in open(map_path):
        parts = line.split()
        if len(parts) >= 2:
            pairs.append((int(parts[0]), int(parts[1])))
    reader = DBReader(in_path)
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for old_key, new_key in pairs:
            i = reader.get_id(old_key)
            if i < 0:
                log.die(f"Key {old_key} not found in database")
            w.write(new_key, reader.get_data(i))
    reader.close()
    if os.path.exists(in_path + "_h.dbtype"):
        hr = DBReader(in_path + "_h")
        with DBWriter(out_path + "_h", hr.base_type,
                      hr.extended_type) as w:
            for old_key, new_key in pairs:
                i = hr.get_id(old_key)
                if i >= 0:
                    w.write(new_key, hr.get_data(i))
        hr.close()
    return 0


def _mask_repeats(num: np.ndarray, max_run: int) -> np.ndarray:
    """Masker::maskRepeats (Masker.cpp:83-118): mask every run of more than
    max_run identical residues."""
    mask = np.zeros(len(num), dtype=bool)
    if len(num) == 0:
        return mask
    change = np.flatnonzero(np.diff(num.astype(np.int64)) != 0) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(num)]])
    for st, en in zip(starts, ends):
        if en - st > max_run:
            mask[st:en] = True
    return mask


# sequences per mask_batch call of masksequence
MASK_CHUNK = 4096
# the ASCII case tables of applySoftmasking; other bytes stay as they are
_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[ord("A"):ord("Z") + 1] += 32
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32


def masksequence(par, command):
    """Soft-mask (lowercase) repeat regions: tantan (--mask 1, default),
    homopolymer runs (--mask-n-repeat N), lowercase input
    (--mask-lower-case) (masksequence.cpp + Masker.cpp:16-55)."""
    from ..data.submat import get_submat
    from ..ops.tantan import likelihood_ratio_matrix, mask_batch

    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    if reader.base_type == dbt.DBTYPE_NUCLEOTIDES:
        submat = get_submat(par.sub_mat.nucl, 1.0, 0.0)
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    lr = likelihood_ratio_matrix(submat)
    x_idx = submat.alphabet_size - 1
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        # tantan over MASK_CHUNK sequences at a time (mask_batch pads and
        # batches them; a sequence's mask is its own)
        for lo in range(0, reader.size, MASK_CHUNK):
            ids = range(lo, min(lo + MASK_CHUNK, reader.size))
            raws = [reader.get_seq(i) for i in ids]
            nums = [np.array(submat.encode(raw), copy=True) for raw in raws]
            if par.mask:
                masked, _ = mask_batch([n.copy() for n in nums], lr, x_idx,
                                       par.mask_prob)
            for j, i in enumerate(ids):
                work = nums[j]
                low = np.frombuffer(raws[j], dtype=np.uint8)
                # stages run sequentially on the numeric sequence, so
                # repeat detection sees tantan's X substitutions
                # (Masker.cpp:16-55)
                if par.mask:
                    work[masked[j] == x_idx] = x_idx
                if par.mask_n_repeat > 0:
                    work[_mask_repeats(work, par.mask_n_repeat)] = x_idx
                if par.mask_lower_case:
                    work[(low >= ord("a")) & (low <= ord("z"))] = x_idx
                # applySoftmasking (Masker.cpp:128-137): masked (incl.
                # original X residues) lowercased, everything else
                # uppercased
                out = np.where(work == x_idx, _LOWER[low], _UPPER[low])
                w.write(reader.get_db_key(i), out.tobytes() + b"\n")
    for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source"):
        src, dst = in_path + suf, out_path + suf
        if os.path.exists(src) and not os.path.lexists(dst):
            os.symlink(os.path.abspath(src), dst)
    return 0


def orftocontig(par, command):
    """Write ORF->contig coordinates as alignment records
    (orftocontig.cpp / Orf::getFromDatabase)."""
    from .nucl_tools import parse_orf_header

    contigs_path, orfs_path, out_path = par.filenames[:3]
    contigs = DBReader(contigs_path)
    orf_h = DBReader(orfs_path + "_h")
    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES) as w:
        order = np.argsort(orf_h.offsets, kind="stable")
        for i in order:
            orf_key = orf_h.get_db_key(int(i))
            loc = parse_orf_header(orf_h.get_data(int(i)))
            if loc is None:
                log.die(f"Invalid ORF header for key {orf_key}")
            contig_key, from_pos, to_pos, minus = loc
            cid = contigs.get_id(contig_key)
            if cid < 0:
                log.die(f"Invalid contig key {contig_key} in ORF header.")
            contig_len = contigs.get_seq_len(cid)
            orf_len = abs(int(to_pos) - int(from_pos)) + 1
            # Orf::getFromDatabase: empty backtrace run through
            # compressAlignment (compress=true default) prints "0M"
            line = (f"{contig_key}\t1\t{autil.fast_seq_id_str(1.0)}\t"
                    f"{autil.format_evalue(0.0)}\t0\t{orf_len - 1}\t"
                    f"{orf_len}\t{from_pos}\t{to_pos}\t{contig_len}\t"
                    f"0M\n")
            w.write(orf_key, line.encode())
    return 0


def aliasdb(par, command):
    """Symlink all files of a DB under a new name (aliasdb.cpp)."""
    in_path, out_path = par.filenames[:2]
    for suf in ("", ".index", ".dbtype", ".lookup", ".source",
                "_h", "_h.index", "_h.dbtype"):
        src, dst = in_path + suf, out_path + suf
        if os.path.exists(src):
            if os.path.lexists(dst):
                os.remove(dst)
            os.symlink(os.path.relpath(src, os.path.dirname(dst) or "."),
                       dst)
    return 0


def swapdb(par, command):
    """Swap a result DB: entries keyed by target, lines keyed by former
    query (swapresults.cpp doSwap without evalue recomputation)."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    swapped = {}
    order = np.argsort(reader.offsets, kind="stable")
    for i in order:
        q_key = reader.get_db_key(int(i))
        for line in reader.get_data(int(i)).split(b"\n"):
            if not line:
                continue
            cols = line.split(b"\t", 1)
            t_key = fast_atoi(cols[0])
            rest = cols[1].decode() if len(cols) > 1 else ""
            swapped.setdefault(t_key, []).append(
                f"{q_key}\t{rest}\n" if rest else f"{q_key}\n")
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for t_key in sorted(swapped):
            w.write(t_key, "".join(swapped[t_key]).encode())
    return 0


def summarizealis(par, command):
    """Per-query alignment summary: nAlns, uniqueCov, cov, avgSeqId.

    Reference src/util/summarizealis.cpp: hits stable-sorted by
    min(qStart,qEnd); uniqueCov merges overlapping query intervals via the
    running previous-end position; all accumulation in float32; fields
    printed with SSTR(float) = %.3f."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    with DBWriter(out_path, dbt.DBTYPE_GENERIC_DB) as w:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            alns = [_aln_parse(line) for line in
                    reader.get_data(i).split(b"\n") if line]
            if not alns:
                w.write(key, b"")
                continue
            alns.sort(key=lambda r: min(r["qStart"], r["qEnd"]))
            res_cov = np.float32(0)
            avg_seq_id = np.float32(0)
            uniq_cov = np.float32(0)
            seq_len = 1
            prev_q_end = -1
            for r in alns:
                seq_len = r["qLen"]
                qs = min(r["qStart"], r["qEnd"])
                qe = max(r["qStart"], r["qEnd"])
                uniq_cov += np.float32(max(prev_q_end, qe)
                                       - max(prev_q_end, qs))
                res_cov += np.float32(qe - qs)
                avg_seq_id += r["seqId"]
                prev_q_end = max(prev_q_end, r["qEnd"])
            avg_seq_id = avg_seq_id / np.float32(len(alns))
            res_cov = res_cov / np.float32(seq_len)
            uniq_cov = uniq_cov / np.float32(seq_len)
            w.write(key, ("%i\t%.3f\t%.3f\t%.3f\n"
                          % (len(alns), uniq_cov, res_cov,
                             avg_seq_id)).encode())
    reader.close()
    return 0
