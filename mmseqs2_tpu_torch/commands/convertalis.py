"""`convertalis`: render an alignment DB as BLAST-tab (m8) / custom columns.

Reference: src/util/convertalignments.cpp. The default --format-output
"query,target,fident,alnlen,mismatch,gapopen,qstart,qend,tstart,tend,evalue,bits"
goes through the per-column renderer where floats print as "%.3f" and doubles
(evalue) as "%.3E" (SSTR, src/commons/Util.cpp:723-740).
mismatch/gapopen derivation at convertalignments.cpp:418-455;
Util::parseFastaHeader accession extraction at Util.cpp:147-229.
The taxonomy columns (taxid, taxname, taxlineage) read the target DB's
taxonomy (taxonomy/ncbi.py). The HTML output (--format-mode 3) is not yet
ported (see ROADMAP.md) and raises.
"""

import math
import re

import numpy as np

from ..db.reader import DBReader
from ..utils import log

_DB_PREFIXES = [
    ("cl|", 3, 1), ("sp|", 3, 1), ("tr|", 3, 1), ("gb|", 3, 1),
    ("ref|", 4, 1), ("pdb|", 4, 1), ("bbs|", 4, 1), ("lcl|", 4, 1),
    ("pir||", 5, 1), ("prf||", 5, 1), ("gnl|", 4, 2), ("pat|", 4, 2),
    ("gi|", 3, 3),
]


def parse_fasta_header(header: str) -> str:
    """Util::parseFastaHeader: accession extraction from the first token."""
    token = header.split()[0] if header.split() else ""
    if not token:
        return ""
    offset = 10 if token.startswith("consensus_") else 0
    for prefix, plen, bar_pos in _DB_PREFIXES:
        if token.startswith(prefix, offset):
            start = offset + plen
            for _ in range(bar_pos - 1):
                end = token.find("|", start)
                if end == -1:
                    return ""
                start = end + 1
            end = token.find("|", start)
            if end == -1:
                return token[start:]
            return token[start:end]
    return token[offset:]


_CIGAR_RE = re.compile(r"(\d+)([MID])")


def expand_backtrace_stats(cigar: str):
    """alnLen, matchCount, gapOpenCount from a compressed backtrace."""
    aln_len = match_count = gap_open = 0
    for cnt, op in _CIGAR_RE.findall(cigar):
        c = int(cnt)
        aln_len += c
        if op == "M":
            match_count += c
        else:
            gap_open += 1
    return aln_len, match_count, gap_open


def expand_cigar(cigar: str) -> str:
    return "".join(op * int(cnt) for cnt, op in _CIGAR_RE.findall(cigar))


class AlnRecord:
    __slots__ = ("db_key", "score", "seq_id", "eval", "q_start", "q_end",
                 "q_len", "db_start", "db_end", "db_len", "backtrace",
                 "q_orf_start", "q_orf_end", "t_orf_start", "t_orf_end")

    @classmethod
    def parse(cls, line: bytes):
        parts = line.split(b"\t")
        r = cls()
        r.db_key = int(parts[0])
        r.score = int(parts[1])
        r.seq_id = np.float32(float(parts[2]))
        r.eval = float(parts[3])
        r.q_start = int(parts[4])
        r.q_end = int(parts[5])
        r.q_len = int(parts[6])
        r.db_start = int(parts[7])
        r.db_end = int(parts[8])
        r.db_len = int(parts[9])
        # column counts (Matcher::parseAlignmentRecord): 10 plain, 11 with
        # backtrace, 14 with ORF positions, 15 with ORF positions+backtrace
        r.q_orf_start = r.q_orf_end = r.t_orf_start = r.t_orf_end = -1
        if len(parts) == 11:
            r.backtrace = parts[10].decode()
        elif len(parts) >= 14:
            r.q_orf_start = int(parts[10])
            r.q_orf_end = int(parts[11])
            r.t_orf_start = int(parts[12])
            r.t_orf_end = int(parts[13])
            r.backtrace = parts[14].decode() if len(parts) >= 15 else ""
        else:
            r.backtrace = ""
        return r

    @property
    def aln_length(self):
        # -1 start positions (score-only records) clamp to 0 before the
        # length computation (Matcher::parseAlignmentRecord:231-235)
        aq = 0 if self.q_start == -1 else self.q_start
        ad = 0 if self.db_start == -1 else self.db_start
        return max(abs(self.q_end - aq), abs(self.db_end - ad)) + 1


def _f3(x) -> str:
    return f"{np.float32(x):.3f}"


FORMAT_BLAST_TAB = 0
FORMAT_SAM = 1
FORMAT_BLAST_WITH_LEN = 2
FORMAT_HTML = 3
FORMAT_BLAST_TAB_WITH_HEADERS = 4


def convertalis(par, command):
    qdb_path, tdb_path, aln_path, out_path = par.filenames[:4]
    fmt = par.format_mode
    if fmt == FORMAT_SAM:
        return _convertalis_sam(par)
    same_db = qdb_path == tdb_path
    qh = DBReader(qdb_path + "_h")
    th = qh if same_db else DBReader(tdb_path + "_h")
    aln = DBReader(aln_path)
    outcodes = [c for c in par.format_output.split(",") if c]
    if fmt == FORMAT_BLAST_WITH_LEN and not par.was_set("format_output"):
        outcodes += ["qlen", "tlen"]
    if fmt == FORMAT_HTML:
        raise NotImplementedError(
            "convertalis --format-mode 3 (HTML) is not yet ported (see "
            "ROADMAP.md)")
    with_len_eval = fmt == FORMAT_BLAST_WITH_LEN

    need_seq = any(c in outcodes for c in
                   ("qseq", "tseq", "qaln", "taln", "qlen", "tlen",
                    "ppos"))
    qseq_db = DBReader(qdb_path) if need_seq else None
    tseq_db = (qseq_db if same_db else DBReader(tdb_path)) if need_seq else None

    evaluer = None
    if "raw" in outcodes:
        from ..ops.evalue import EvalueComputation
        from .common import get_sub_mat
        tr = DBReader(tdb_path)
        evaluer = EvalueComputation(tr.total_residues(), get_sub_mat(par),
                                    par.gap_open.aa, par.gap_extend.aa)
        tr.close()

    need_set = any(c in outcodes for c in ("qset", "qsetid", "tset",
                                           "tsetid"))
    q_lookup = t_lookup = q_source = t_source = None
    if need_set:
        qfull = DBReader(qdb_path)
        q_lookup = qfull.read_lookup()
        qfull.close()
        q_source = _read_source_map(qdb_path)
        if same_db:
            t_lookup, t_source = q_lookup, q_source
        else:
            tfull = DBReader(tdb_path)
            t_lookup = tfull.read_lookup()
            tfull.close()
            t_source = _read_source_map(tdb_path)
    taxonomy = tax_mapping = None
    if any(c in outcodes for c in ("taxid", "taxname", "taxlineage")):
        from ..taxonomy.ncbi import MappingReader, NcbiTaxonomy
        taxonomy = NcbiTaxonomy.open_taxonomy(tdb_path)
        tax_mapping = MappingReader(tdb_path)
    submat_pp = None
    if "ppos" in outcodes:
        from .common import get_sub_mat
        submat_pp = get_sub_mat(par)

    writer = None
    if par.db_output:
        # reference convertalignments.cpp:265,843 — --db-output writes one
        # GENERIC_DB entry per query instead of a flat file
        from ..db import dbtype as dbt
        from ..db.writer import DBWriter
        writer = DBWriter(out_path, dbt.DBTYPE_GENERIC_DB,
                          compressed=bool(par.compressed))
    out_lines = []
    if fmt == FORMAT_BLAST_TAB_WITH_HEADERS and outcodes:
        # --format-mode 4: column-name header line
        # (convertalignments.cpp:319-328)
        out_lines.append("\t".join(outcodes) + "\n")
    # reference opens the result DB with LINEAR_ACCCESS: iterate in data
    # (offset) order, not key order (DBReader.h sort modes)
    order = np.argsort(aln.offsets, kind="stable")
    for i in (int(x) for x in order):
        query_key = aln.get_db_key(i)
        qhid = qh.get_id(query_key)
        query_id = parse_fasta_header(qh.get_data(qhid).decode())
        data = aln.get_data(i)
        q_lines = [] if writer is not None else out_lines
        for line in data.split(b"\n"):
            if not line:
                continue
            res = AlnRecord.parse(line)
            thid = th.get_id(res.db_key)
            target_id = parse_fasta_header(th.get_data(thid).decode())
            gap_open_count = 0
            aln_len = res.aln_length
            identical = 0
            if res.backtrace:
                aln_len, match_count, gap_open_count = \
                    expand_backtrace_stats(res.backtrace)
                identical = int(res.seq_id * np.float32(aln_len)
                                + np.float32(0.5))
                miss_match = match_count - identical
            else:
                adj_q = 0 if res.q_start == -1 else res.q_start
                adj_t = 0 if res.db_start == -1 else res.db_start
                best_match = np.float32(min(abs(res.q_end - adj_q),
                                            abs(res.db_end - adj_t)))
                miss_match = int(best_match * (np.float32(1.0) - res.seq_id)
                                 + np.float32(0.5))

            cols = []
            for code in outcodes:
                if code == "query":
                    cols.append(query_id)
                elif code == "target":
                    cols.append(target_id)
                elif code == "fident":
                    cols.append(_f3(res.seq_id))
                elif code == "pident":
                    cols.append(_f3(res.seq_id * np.float32(100)))
                elif code == "nident":
                    cols.append(str(identical))
                elif code == "alnlen":
                    cols.append(str(aln_len))
                elif code == "mismatch":
                    cols.append(str(miss_match))
                elif code == "gapopen":
                    cols.append(str(gap_open_count))
                elif code == "qstart":
                    cols.append(str(res.q_start + 1))
                elif code == "qend":
                    cols.append(str(res.q_end + 1))
                elif code == "qlen":
                    cols.append(str(res.q_len))
                elif code == "tstart":
                    cols.append(str(res.db_start + 1))
                elif code == "tend":
                    cols.append(str(res.db_end + 1))
                elif code == "tlen":
                    cols.append(str(res.db_len))
                elif code == "evalue":
                    cols.append(f"{res.eval:.2E}" if with_len_eval
                                else f"{res.eval:.3E}")
                elif code == "bits":
                    cols.append(str(res.score))
                elif code == "raw":
                    cols.append(str(int(
                        evaluer.compute_raw_score_from_bit_score(res.score)
                        + 0.5)))
                elif code == "qcov":
                    cols.append(_f3((res.q_end - res.q_start + 1)
                                    / np.float32(res.q_len)))
                elif code == "tcov":
                    cols.append(_f3((res.db_end - res.db_start + 1)
                                    / np.float32(res.db_len)))
                elif code == "qheader":
                    cols.append(qh.get_data(qhid).decode().rstrip("\n"))
                elif code == "theader":
                    cols.append(th.get_data(thid).decode().rstrip("\n"))
                elif code == "cigar":
                    cols.append(res.backtrace)
                elif code == "qseq":
                    cols.append(qseq_db.get_seq(
                        qseq_db.get_id(query_key)).decode())
                elif code == "tseq":
                    cols.append(tseq_db.get_seq(
                        tseq_db.get_id(res.db_key)).decode())
                elif code in ("qaln", "taln"):
                    bt = expand_cigar(res.backtrace)
                    if code == "qaln":
                        seq = qseq_db.get_seq(
                            qseq_db.get_id(query_key)).decode()
                        pos, gap_op = res.q_start, "I"
                    else:
                        seq = tseq_db.get_seq(
                            tseq_db.get_id(res.db_key)).decode()
                        pos, gap_op = res.db_start, "D"
                    frag = []
                    for op in bt:
                        if op == "M" or op == gap_op:
                            frag.append(seq[pos])
                            pos += 1
                        else:
                            frag.append("-")
                    cols.append("".join(frag))
                elif code == "empty":
                    cols.append("-")
                elif code == "qframe":
                    # C-style truncating modulo (convertalignments.cpp:671)
                    if res.q_start <= res.q_end:
                        cols.append(str(int(math.fmod(res.q_start - 1, 3))
                                        + 1))
                    else:
                        cols.append(str(-(int(math.fmod(
                            res.q_len - res.q_start, 3)) + 1)))
                elif code == "tframe":
                    if res.db_start <= res.db_end:
                        cols.append(str(int(math.fmod(res.db_start - 1, 3))
                                        + 1))
                    else:
                        cols.append(str(-(int(math.fmod(
                            res.db_len - res.db_start, 3)) + 1)))
                elif code == "qorfstart":
                    cols.append(str(res.q_orf_start))
                elif code == "qorfend":
                    cols.append(str(res.q_orf_end))
                elif code == "torfstart":
                    cols.append(str(res.t_orf_start))
                elif code == "torfend":
                    cols.append(str(res.t_orf_end))
                elif code == "qsetid":
                    cols.append(str(q_lookup[query_key][1]))
                elif code == "qset":
                    cols.append(q_source.get(q_lookup[query_key][1], ""))
                elif code == "tsetid":
                    cols.append(str(t_lookup[res.db_key][1]))
                elif code == "tset":
                    cols.append(t_source.get(t_lookup[res.db_key][1], ""))
                elif code == "taxid":
                    cols.append(str(tax_mapping.lookup(res.db_key)))
                elif code == "taxname":
                    node = taxonomy.taxon_node(
                        tax_mapping.lookup(res.db_key))
                    cols.append(node.name if node is not None
                                else "unclassified")
                elif code == "taxlineage":
                    node = taxonomy.taxon_node(
                        tax_mapping.lookup(res.db_key))
                    cols.append(taxonomy.tax_lineage(node, True)
                                if node is not None else "unclassified")
                elif code == "ppos":
                    # fraction of positive-scoring match columns
                    # (convertalignments.cpp:640-669); SSTR(float) = %.3f
                    ppos = np.float32(0)
                    if res.backtrace:
                        bt = expand_cigar(res.backtrace)
                        q_s = qseq_db.get_seq(
                            qseq_db.get_id(query_key))
                        t_s = tseq_db.get_seq(
                            tseq_db.get_id(res.db_key))
                        enc = submat_pp.make_aa2num_table()
                        sm = submat_pp.sub_matrix
                        qp, tp = res.q_start, res.db_start
                        pos_cnt = 0
                        match_cnt = 0
                        for op in bt:
                            if op == "M":
                                pos_cnt += int(sm[enc[q_s[qp]],
                                                  enc[t_s[tp]]] > 0)
                                match_cnt += 1
                                qp += 1
                                tp += 1
                            elif op == "D":
                                tp += 1
                            else:
                                qp += 1
                        if match_cnt:
                            ppos = np.float32(pos_cnt) / np.float32(
                                match_cnt)
                    cols.append(_f3(ppos))
                else:
                    log.die(f"Unsupported --format-output key: {code}")
            q_lines.append("\t".join(cols) + "\n")
        if writer is not None:
            writer.write(query_key, "".join(q_lines).encode())
    if writer is not None:
        writer.close()
    else:
        with open(out_path, "w") as f:
            f.write("".join(out_lines))
    aln.close()
    qh.close()
    if th is not qh:
        th.close()
    return 0


def _aligned_seq(seq, start, bt, is_target):
    """printSeqBasedOnAln (convertalignments.cpp:28-63), protein case."""
    out = []
    pos = start
    keep_op = "D" if is_target else "I"
    for op in bt:
        if op == "M" or op == keep_op:
            out.append(seq[pos])
            pos += 1
        else:
            out.append("-")
    return "".join(out)


def _convertalis_sam(par):
    """--format-mode 1: SAM output (convertalignments.cpp:272-300,718-765).
    Header: @HD + one @SQ per target at first appearance in result order;
    records: flag 16 for reversed query coordinates, pos = min target
    coordinate, MAPQ from the raw score, stored (compressed) cigar, the
    query segment, AS/NM tags."""
    import math

    from ..ops.evalue import EvalueComputation
    from .common import get_sub_mat

    qdb_path, tdb_path, aln_path, out_path = par.filenames[:4]
    same_db = qdb_path == tdb_path
    qh = DBReader(qdb_path + "_h")
    th = qh if same_db else DBReader(tdb_path + "_h")
    qseq = DBReader(qdb_path)
    tseq = qseq if same_db else DBReader(tdb_path)
    aln = DBReader(aln_path)
    evaluer = EvalueComputation(tseq.total_residues(), get_sub_mat(par),
                                par.gap_open.aa, par.gap_extend.aa)
    order = [int(x) for x in np.argsort(aln.offsets, kind="stable")]
    out = ["@HD\tVN:1.4\tSO:queryname\n"]
    seen = set()
    for i in order:
        for line in aln.get_data(i).split(b"\n"):
            if not line:
                continue
            tkey = int(line.split(b"\t")[0])
            if tkey in seen:
                continue
            seen.add(tkey)
            t_len = tseq.get_seq_len(tseq.get_id(tkey))
            tid = parse_fasta_header(th.get_data(th.get_id(tkey)).decode())
            out.append(f"@SQ\tSN:{tid}\tLN:{t_len}\n")
    for i in order:
        query_key = aln.get_db_key(i)
        query_id = parse_fasta_header(
            qh.get_data(qh.get_id(query_key)).decode())
        q_seq = qseq.get_seq(qseq.get_id(query_key)).decode()
        for line in aln.get_data(i).split(b"\n"):
            if not line:
                continue
            res = AlnRecord.parse(line)
            tid = parse_fasta_header(
                th.get_data(th.get_id(res.db_key)).decode())
            forward = res.q_end > res.q_start
            raw = int(evaluer.compute_raw_score_from_bit_score(res.score)
                      + 0.5)
            try:
                mapq_f = -4.343 * math.log(math.exp(-float(raw)))
            except (OverflowError, ValueError):
                mapq_f = float("inf")
            mapq = 254 if not math.isfinite(mapq_f + 4.99) \
                else min(254, int(mapq_f + 4.99))
            aln_len = res.aln_length
            miss_match = 0
            if res.backtrace:
                aln_len, match_count, _ = \
                    expand_backtrace_stats(res.backtrace)
                identical = int(res.seq_id * np.float32(aln_len)
                                + np.float32(0.5))
                miss_match = match_count - identical
            else:
                adj_q = 0 if res.q_start == -1 else res.q_start
                adj_t = 0 if res.db_start == -1 else res.db_start
                best_match = np.float32(min(abs(res.q_end - adj_q),
                                            abs(res.db_end - adj_t)))
                miss_match = int(best_match
                                 * (np.float32(1.0) - res.seq_id)
                                 + np.float32(0.5))
            start = min(res.q_start, res.q_end)
            end = max(res.q_start, res.q_end)
            out.append(
                f"{query_id}\t{0 if forward else 16}\t{tid}\t"
                f"{min(res.db_start + 1, res.db_end + 1)}\t{mapq}\t"
                f"{res.backtrace}\t*\t0\t0\t{q_seq[start:end + 1]}\t*"
                f"\tAS:i:{raw}\tNM:i:{miss_match}\n")
    with open(out_path, "w") as f:
        f.write("".join(out))
    for r in {id(aln): aln, id(qh): qh, id(th): th, id(qseq): qseq,
              id(tseq): tseq}.values():
        r.close()
    return 0


def _read_source_map(db_path):
    import os
    out = {}
    p = db_path + ".source"
    if os.path.exists(p):
        for line in open(p):
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[int(parts[0])] = parts[1]
    return out
