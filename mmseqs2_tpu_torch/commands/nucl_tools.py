"""Nucleotide search support commands: extractframes, splitsequence,
offsetalignment.

Reference: src/util/extractframes.cpp, src/util/splitsequence.cpp,
src/util/offsetalignment.cpp + src/commons/Orf.cpp header format
(`key\\tfrom±len[\\tincomplete]`).
"""

import os

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from .common import fast_atoi

DB_KEY_INVALID = (1 << 64) - 1

COMPLEMENT = bytes.maketrans(
    b"ACGTUacgtuNnRYKMrykmBVDHbvdhSWsw",
    b"TGCAAtgcaaNnYRMKyrmkVBHDvbhdSWsw")


def write_orf_header(key: int, from_pos: int, to_pos: int,
                     incomplete_start=False, incomplete_end=False) -> bytes:
    sign = "+" if from_pos < to_pos else "-"
    length = abs(from_pos - to_pos)
    out = f"{key}\t{from_pos}{sign}{length}"
    complete = int(incomplete_start) | (int(incomplete_end) << 1)
    if complete:
        out += f"\t{complete}"
    return (out + "\n").encode()


def parse_orf_header(header: bytes):
    """Orf::parseOrfHeader -> (id, from, to, strand_minus) or None."""
    parts = header.split()
    if len(parts) < 2:
        return None
    loc = parts[1]
    pos = 0
    while pos < len(loc) and loc[pos:pos + 1].isdigit():
        pos += 1
    if pos == 0 or pos >= len(loc) or loc[pos:pos + 1] not in (b"+", b"-"):
        return None
    is_plus = loc[pos:pos + 1] == b"+"
    rest = loc[pos + 1:]
    if not rest or not rest.isdigit():
        return None
    from_pos = int(loc[:pos])
    length = int(rest)
    to_pos = from_pos + length if is_plus else from_pos - length
    return (fast_atoi(parts[0]), from_pos, to_pos, not is_plus)


def _get_frames(spec: str) -> set:
    return {int(f) for f in spec.split(",") if f.strip()} if spec else set()


def extractframes(par, command):
    """Extract forward/reverse(-complement) frames of every sequence; output
    keys are renumbered 0..N-1 in write order, headers carry the original
    key + frame coordinates (extractframes.cpp)."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    hreader = DBReader(in_path + "_h")
    fwd = _get_frames(par.forward_frames)
    rev = _get_frames(par.reverse_frames)

    new_key = 0
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w, \
            DBWriter(out_path + "_h", dbt.DBTYPE_GENERIC_DB) as wh, \
            open(out_path + ".lookup", "w") as lk:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            seq = reader.get_seq(i)
            seq_len = len(seq)
            for frame in (1, 2, 3):
                if frame not in fwd:
                    continue
                sub = seq[frame - 1:]
                w.write(new_key, sub + b"\n")
                wh.write(new_key, write_orf_header(key, frame - 1,
                                                   seq_len - 1))
                lk.write(f"{new_key}\t{key}\t0\n")
                new_key += 1
            if rev:
                rc = seq[::-1].translate(COMPLEMENT)
            for frame in (1, 2, 3):
                if frame not in rev:
                    continue
                sub = rc[frame - 1:]
                w.write(new_key, sub + b"\n")
                wh.write(new_key, write_orf_header(key, seq_len - 1,
                                                   frame - 1))
                lk.write(f"{new_key}\t{key}\t0\n")
                new_key += 1
    reader.close()
    hreader.close()
    # source file softlink equivalent
    if os.path.exists(in_path + ".source"):
        import shutil
        shutil.copyfile(in_path + ".source", out_path + ".source")
    return 0


def splitsequence(par, command):
    """Split sequences longer than --max-seq-len into overlapping chunks
    (hard mode); a no-op softlink when nothing exceeds the limit."""
    in_path, out_path = par.filenames[:2]
    max_len = par.max_seq_len if par.was_set("max_seq_len") else 10000
    overlap = par.sequence_overlap if par.was_set("sequence_overlap") else 300

    reader = DBReader(in_path)
    if all(reader.get_seq_len(i) <= max_len for i in range(reader.size)):
        # softlinkDb(..., DBFiles::SEQUENCE_DB): link sequence + header dbs
        reader.close()
        for suf in ("", ".index", ".dbtype", ".lookup", ".source",
                    "_h", "_h.index", "_h.dbtype"):
            src = in_path + suf
            dst = out_path + suf
            if os.path.exists(src):
                if os.path.lexists(dst):
                    os.remove(dst)
                os.symlink(os.path.abspath(src), dst)
        return 0

    hreader = DBReader(in_path + "_h")
    new_key = 0
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w, \
            DBWriter(out_path + "_h", dbt.DBTYPE_GENERIC_DB) as wh:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            seq = reader.get_seq(i)
            seq_len = len(seq)
            header = hreader.get_data(hreader.get_id(key))
            loc = None if par.headers_split_mode else parse_orf_header(header)
            if loc is not None:
                base_key = loc[0]
                from_pos = loc[2] if loc[3] else loc[1]
                strand_minus = loc[3]
            else:
                base_key = key
                from_pos = 0
                strand_minus = False
            split_cnt = int(np.ceil(np.float32(seq_len)
                                    / np.float32(max_len - overlap)))
            for split in range(split_cnt):
                start = split * max_len - split * overlap
                length = min(max_len, seq_len - start)
                w.write(new_key, seq[start:start + length] + b"\n")
                if strand_minus:
                    wh.write(new_key, write_orf_header(
                        base_key, from_pos - start,
                        from_pos - start - (length - 1)))
                else:
                    wh.write(new_key, write_orf_header(
                        base_key, from_pos + start,
                        from_pos + start + length - 1))
                new_key += 1
    reader.close()
    hreader.close()
    return 0


def _read_aln_line(line: bytes):
    """Parse an alignment line into a mutable dict (compressed backtrace is
    expanded, readAlignmentResults(readCompressed=true))."""
    p = line.split(b"\t")
    res = {
        "dbKey": fast_atoi(p[0]), "score": int(p[1]), "seqId": p[2],
        "eval": p[3], "qStart": int(p[4]), "qEnd": int(p[5]),
        "qLen": int(p[6]), "dbStart": int(p[7]), "dbEnd": int(p[8]),
        "dbLen": int(p[9]),
        # readCompressed=true keeps the cigar compressed
        "backtrace": p[10].decode() if len(p) > 10 else "",
        "qOrfStart": -1, "qOrfEnd": -1, "dbOrfStart": -1, "dbOrfEnd": -1,
    }
    return res


def _res_to_line(r) -> str:
    # resultToBuffer re-formats seqId/eval from the parsed floats
    from ..align import util as autil
    cols = [str(r["dbKey"]), str(r["score"]),
            autil.fast_seq_id_str(np.float32(float(r["seqId"]))),
            autil.format_evalue(float(r["eval"])),
            str(r["qStart"]), str(r["qEnd"]),
            str(r["qLen"]), str(r["dbStart"]), str(r["dbEnd"]),
            str(r["dbLen"]), str(r["qOrfStart"]), str(r["qOrfEnd"]),
            str(r["dbOrfStart"]), str(r["dbOrfEnd"])]
    if r["backtrace"]:
        cols.append(r["backtrace"])
    return "\t".join(cols) + "\n"


def offsetalignment(par, command):
    """Map ORF/frame/split coordinates in an alignment DB back to the
    original (source) sequences; one output entry per source contig."""
    qsrc, qorf, tsrc, torf, aln_path, out_path = par.filenames[:6]

    q_nucl = DBReader(qsrc).base_type == dbt.DBTYPE_NUCLEOTIDES
    t_nucl = DBReader(tsrc).base_type == dbt.DBTYPE_NUCLEOTIDES
    search_type = par.search_type
    seqtarget_nuc = True
    if search_type == 2:          # translated
        seqtarget_nuc = False
    elif search_type == 3:
        seqtarget_nuc = True
    is_nucl_nucl = q_nucl and t_nucl and seqtarget_nuc
    is_trans = (not is_nucl_nucl) and t_nucl

    qsrc_r = DBReader(qsrc)
    qorf_h = DBReader(qorf + "_h")
    torf_h = qorf_h if qorf == torf else DBReader(torf + "_h")
    tsrc_r = qsrc_r if tsrc == qsrc else DBReader(tsrc)
    aln = DBReader(aln_path)

    def update(results, data, qloc):
        for line in data.split(b"\n"):
            if not line:
                continue
            r = _read_aln_line(line)
            tid = torf_h.get_id(r["dbKey"])
            theader = torf_h.get_data(tid)
            tloc = parse_orf_header(theader)
            if is_nucl_nucl or is_trans:
                r["dbKey"] = tloc[0] if tloc else r["dbKey"]
                if tloc:
                    from_pos = tloc[1]
                    strand_minus = tloc[3]
                    to_pos = tloc[2]
                else:
                    strand_minus = False
                    from_pos = r["dbLen"] - 1 if strand_minus else 0
                    to_pos = 0
                db_s = r["dbStart"] if is_nucl_nucl else r["dbStart"] * 3
                db_e = r["dbEnd"] if is_nucl_nucl else r["dbEnd"] * 3
                r["dbOrfStart"] = from_pos
                r["dbOrfEnd"] = to_pos
                if tloc and tloc[3]:
                    r["dbStart"] = from_pos - db_s
                    r["dbEnd"] = from_pos - db_e
                    if not is_nucl_nucl:
                        r["dbEnd"] -= 2
                else:
                    r["dbStart"] = from_pos + db_s
                    r["dbEnd"] = from_pos + db_e
                    if not is_nucl_nucl:
                        r["dbEnd"] += 2
            if qloc is not None:
                q_s = r["qStart"] if is_nucl_nucl else r["qStart"] * 3
                q_e = r["qEnd"] if is_nucl_nucl else r["qEnd"] * 3
                from_pos = qloc[1]
                r["qOrfStart"] = from_pos
                r["qOrfEnd"] = qloc[2]
                if qloc[3]:
                    r["qStart"] = from_pos - q_s
                    r["qEnd"] = from_pos - q_e
                    if not is_nucl_nucl:
                        r["qEnd"] -= 2
                else:
                    r["qStart"] = from_pos + q_s
                    r["qEnd"] = from_pos + q_e
                    if not is_nucl_nucl:
                        r["qEnd"] += 2
            results.append(r)

    # orf key -> contig key via the query ORF headers
    contig_orfs = {}
    for i in range(aln.size):
        orf_key = aln.get_db_key(i)
        qid = qorf_h.get_id(orf_key)
        if qid < 0:
            continue
        loc = parse_orf_header(qorf_h.get_data(qid))
        contig = loc[0] if loc else orf_key
        contig_orfs.setdefault(contig, []).append(orf_key)

    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES) as w:
        if q_nucl:
            for i in range(qsrc_r.size):
                contig = qsrc_r.get_db_key(i)
                q_len = qsrc_r.get_seq_len(i)
                results = []
                for orf_key in contig_orfs.get(contig, []):
                    oid = aln.get_id(orf_key)
                    if oid < 0:
                        continue
                    qid = qorf_h.get_id(orf_key)
                    qloc = parse_orf_header(qorf_h.get_data(qid))
                    update(results, aln.get_data(oid), qloc)
                    if not par.merge_query:
                        # per-ORF entries, contig-keyed, no length update
                        # (offsetalignment.cpp:402-421)
                        w.write(contig, "".join(
                            _res_to_line(r) for r in results).encode())
                        results = []
                if not par.merge_query:
                    continue
                for r in results:
                    r["qLen"] = q_len
                    tid = tsrc_r.get_id(r["dbKey"])
                    if tid >= 0:
                        r["dbLen"] = tsrc_r.get_seq_len(tid)
                if par.chain_alignments:
                    results = _chain_alignment_hits(results)
                else:
                    # stable sort by compareHits (eval, -score, dbLen,
                    # dbKey)
                    results.sort(
                        key=lambda r: (float(r["eval"]), -r["score"],
                                       r["dbLen"], r["dbKey"]))
                w.write(contig, "".join(
                    _res_to_line(r) for r in results).encode())
        else:
            for i in range(aln.size):
                qkey = aln.get_db_key(i)
                results = []
                update(results, aln.get_data(i), None)
                for r in results:
                    tid = tsrc_r.get_id(r["dbKey"])
                    if tid >= 0:
                        r["dbLen"] = tsrc_r.get_seq_len(tid)
                results.sort(key=lambda r: (float(r["eval"]), -r["score"],
                                            r["dbLen"], r["dbKey"]))
                w.write(qkey, "".join(
                    _res_to_line(r) for r in results).encode())
    return 0


def _chain_alignment_hits(results):
    """chainAlignmentHits (offsetalignment.cpp:20-81): stable-sort by
    (dbKey, query strand, target strand, diagonal, dbStart), then merge
    consecutive same-diagonal overlapping hits into one region."""
    if len(results) <= 1:
        return results

    def sort_key(r):
        q_rev = r["qStart"] > r["qEnd"]
        t_rev = r["dbStart"] > r["dbEnd"]
        qs = min(r["qStart"], r["qEnd"])
        ts = min(r["dbStart"], r["dbEnd"])
        return (r["dbKey"], q_rev, t_rev, qs - ts, ts)

    results = sorted(results, key=sort_key)
    out = []
    curr = None
    prev_diag = None
    for idx, r in enumerate(results):
        q_rev = r["qStart"] > r["qEnd"]
        t_rev = r["dbStart"] > r["dbEnd"]
        qs, qe = sorted((r["qStart"], r["qEnd"]))
        ts, te = sorted((r["dbStart"], r["dbEnd"]))
        if curr is None:
            curr = dict(r)
            curr["qStart"], curr["qEnd"] = qs, qe
            curr["dbStart"], curr["dbEnd"] = ts, te
        diag = qs - ts
        next_diag = None
        next_q_rev = next_t_rev = True
        if idx + 1 < len(results):
            nr = results[idx + 1]
            next_diag = (min(nr["qStart"], nr["qEnd"])
                         - min(nr["dbStart"], nr["dbEnd"]))
            next_q_rev = nr["qStart"] > nr["qEnd"]
            next_t_rev = nr["dbStart"] > nr["dbEnd"]
        q_overlap = qs <= curr["qEnd"] <= qe
        t_overlap = ts <= curr["dbEnd"] <= te
        if ((diag == next_diag or diag == prev_diag)
                and q_overlap and t_overlap):
            curr["qStart"] = min(curr["qStart"], qs)
            curr["qEnd"] = max(curr["qEnd"], qe)
            curr["dbStart"] = min(curr["dbStart"], ts)
            curr["dbEnd"] = max(curr["dbEnd"], te)
        prev_diag = diag
        different_key = curr["dbKey"] != r["dbKey"]
        last = idx == len(results) - 1
        if (different_key or last or next_diag != diag
                or next_q_rev != q_rev or next_t_rev != t_rev):
            if q_rev:
                curr["qStart"], curr["qEnd"] = curr["qEnd"], curr["qStart"]
            if t_rev:
                curr["dbStart"], curr["dbEnd"] = \
                    curr["dbEnd"], curr["dbStart"]
            out.append(curr)
            curr = None
    return out


# -- ORF extraction (src/commons/Orf.cpp findForward + extractorfs.cpp) -------

IUPAC_REVCOMP = bytes(
    ord('.') if c == '.' else ord(c)
    for c in ("." * 64
              + ".TVGH..CD..M.KN...YSAABW.R......"
              + ".tvgh..cd..m.kn...ysaabw.r......"
              + "." * 128))
CHAR_MAX = 127


def _find_forward(seq: bytes, frames: set, start_mode: int,
                  min_len: int, max_len: int, max_gaps: int,
                  start_codons: set, stop_codons: set, strand_minus: bool):
    """Orf::findForward state machine. seq is padded with CHAR_MAX bytes."""
    n = len(seq) - 16                       # true length (padding appended)
    results = []
    inside = [True, True, True]
    has_start = [False, False, False]
    gaps = [0, 0, 0]
    length = [0, 0, 0]
    from_ = [0, 1, 2]
    upper = bytes(c if c == CHAR_MAX else (c & ~0x20) for c in seq)
    limit = n - 2
    for i in range(0, limit, 3):
        for pos in range(i, i + 3):
            codon = upper[pos:pos + 3]
            frame = pos % 3
            if (frame + 1) not in frames:
                continue
            this_incomplete = CHAR_MAX in codon
            nxt = upper[pos + 3:pos + 6]
            is_last = (not this_incomplete) and (CHAR_MAX in nxt)
            if start_mode == 0:          # START_TO_STOP
                should_start = (not inside[frame]) and codon in start_codons
            elif start_mode == 1:        # ANY_TO_STOP
                should_start = not inside[frame]
            else:                        # LAST_START_TO_STOP
                should_start = codon in start_codons
            if should_start:
                inside[frame] = True
                has_start[frame] = True
                from_[frame] = pos
                gaps[frame] = 0
                length[frame] = 0
            stop = codon in stop_codons
            if inside[frame]:
                if not stop:
                    length[frame] += 1
                if (b'N' in codon
                        or any(IUPAC_REVCOMP[c] == ord('.') for c in codon)):
                    gaps[frame] += 1
            if inside[frame] and (stop or is_last):
                inside[frame] = False
                if length[frame] == 0 and stop:
                    continue
                to = pos + (2 if (is_last and not stop) else -1)
                if (gaps[frame] > max_gaps or length[frame] > max_len
                        or length[frame] < min_len):
                    continue
                results.append((from_[frame], to, not has_start[frame],
                                not stop, strand_minus))
    return results


def _orf_revcomp(seq: bytes) -> bytes:
    out = bytes(IUPAC_REVCOMP[c] for c in seq[::-1])
    return out.replace(b'.', b'N')


def extractorfs(par, command):
    """Extract (and optionally translate) ORFs from a nucleotide DB
    (extractorfs.cpp); output keys renumbered in write order."""
    from ..data.translate import TranslateNucl

    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    trans = TranslateNucl(par.translation_table)
    if par.use_all_table_starts:
        start_codons = {c.encode() for c in trans.get_start_codons()}
    else:
        start_codons = {b"ATG"}
    stop_codons = {c.encode() for c in trans.get_stop_codons()}
    fwd = _get_frames(par.forward_frames)
    rev = _get_frames(par.reverse_frames)
    out_type = (dbt.DBTYPE_AMINO_ACIDS if par.translate
                else reader.base_type)

    new_key = 0
    pad = bytes([CHAR_MAX]) * 16
    with DBWriter(out_path, out_type) as w, \
            DBWriter(out_path + "_h", dbt.DBTYPE_GENERIC_DB) as wh, \
            open(out_path + ".lookup", "w") as lk:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            raw = reader.get_seq(i)
            if len(raw) < 3:
                continue
            seq = raw.replace(b'U', b'T').replace(b'u', b't')
            rc = _orf_revcomp(seq)
            locs = []
            if fwd:
                locs += _find_forward(seq + pad, fwd, par.orf_start_mode,
                                      par.orf_min_length, par.orf_max_length,
                                      par.orf_max_gaps, start_codons,
                                      stop_codons, False)
            if rev:
                locs += _find_forward(rc + pad, rev, par.orf_start_mode,
                                      par.orf_min_length, par.orf_max_length,
                                      par.orf_max_gaps, start_codons,
                                      stop_codons, True)
            L = len(seq)
            for from_, to, inc_start, inc_end, minus in locs:
                if par.contig_start_mode < 2 and \
                        (inc_start == bool(par.contig_start_mode)):
                    continue
                if par.contig_end_mode < 2 and \
                        (inc_end == bool(par.contig_end_mode)):
                    continue
                sub = (rc if minus else seq)[from_:to + 1]
                from_pos, to_pos = from_, to
                if minus:
                    from_pos = (L - 1) - from_
                    to_pos = (L - 1) - to
                if par.translate:
                    sub_len = len(sub)
                    if sub_len % 3 != 0:
                        sub_len -= sub_len % 3
                    if sub_len < 3:
                        continue
                    if sub_len > 3 * par.max_seq_len:
                        sub_len = 3 * par.max_seq_len
                    data = trans.translate(sub[:sub_len])
                else:
                    data = sub
                w.write(new_key, data + b"\n")
                wh.write(new_key, write_orf_header(key, from_pos, to_pos,
                                                   inc_start, inc_end))
                lk.write(f"{new_key}\t{key}\t0\n")
                new_key += 1
    reader.close()
    if os.path.exists(in_path + ".source"):
        import shutil
        shutil.copyfile(in_path + ".source", out_path + ".source")
    return 0


def translatenucs(par, command):
    """Translate a nucleotide sequence DB codon-wise to amino acids
    (src/util/translatenucs.cpp).

    --add-orf-stop (translatenucs.cpp:57-108): bracket complete ORFs with
    '*' (start only when the ORF header lacks the incomplete-start flag,
    end only when the translation does not already end in '*')."""
    from ..data.translate import TranslateNucl

    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    header = DBReader(in_path + "_h") if par.add_orf_stop else None
    trans = TranslateNucl(par.translation_table)
    with DBWriter(out_path, dbt.DBTYPE_AMINO_ACIDS) as w:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            seq = reader.get_seq(i)
            codons = (len(seq) // 3) * 3
            if codons < 3:
                w.write(key, b"\n")
                continue
            aa = trans.translate(seq[:codons])
            if header is not None:
                hdata = header.get_data(header.get_id(key))
                inc_start, inc_end = _orf_incomplete_flags(hdata)
                if not inc_start:
                    aa = b"*" + aa
                if not inc_end and not aa.endswith(b"*"):
                    aa = aa + b"*"
            w.write(key, aa + b"\n")
    reader.close()
    for suf in ("_h", "_h.index", "_h.dbtype"):
        src, dst = in_path + suf, out_path + suf
        if os.path.exists(src) and not os.path.exists(dst):
            import shutil
            shutil.copyfile(src, dst)
    return 0


def _orf_incomplete_flags(header_data: bytes):
    """Orf::parseOrfHeader incomplete bits: the optional 3rd column encodes
    hasIncompleteStart | hasIncompleteEnd << 1 (Orf.cpp:444-460)."""
    parts = header_data.split(b"\t")
    complete = 0
    if len(parts) >= 3:
        try:
            complete = int(parts[2])
        except ValueError:
            complete = 0
    return bool(complete & 1), bool(complete & 2)


def result2dnamsa(par, command):
    """Build a DNA MSA DB from nucleotide alignment results
    (reference src/util/result2dnamsa.cpp): query written verbatim,
    each hit rendered gap-padded in query coordinates, minus-strand hits
    complemented."""
    qdb, tdb, resdb, out = par.filenames[:4]
    same_db = qdb == tdb
    q = DBReader(qdb)
    qh = DBReader(qdb + "_h")
    t = q if same_db else DBReader(tdb)
    th = qh if same_db else DBReader(tdb + "_h")
    res = DBReader(resdb)
    with DBWriter(out, dbt.DBTYPE_MSA_DB,
                  compressed=bool(par.compressed)) as w:
        for i in (int(x) for x in np.argsort(res.offsets, kind="stable")):
            query_key = res.get_db_key(i)
            qid = q.get_id(query_key)
            entry = bytearray()
            if not par.skip_query:
                entry += b">" + qh.get_data(qid)
                entry += q.get_data(qid)
            for line in res.get_data(i).split(b"\n"):
                if not line:
                    continue
                f = line.split(b"\t")
                db_key = fast_atoi(f[0])
                q_start, q_end, q_len = int(f[4]), int(f[5]), int(f[6])
                db_start, db_end = int(f[7]), int(f[8])
                from .convertalis import expand_cigar
                # backtrace at col 10 (11-col) or col 14 (ORF 15-col records)
                bt_col = 14 if len(f) >= 15 else 10
                bt = expand_cigar(f[bt_col].decode()) \
                    if len(f) > bt_col else ""
                tid = t.get_id(db_key)
                entry += b">" + th.get_data(tid)
                tseq = t.get_data(tid)
                q_rev = q_start > q_end
                t_rev = db_start > db_end
                reverse_strand = False
                if q_rev and t_rev:
                    db_start, db_end = db_end, db_start
                    bt = bt[::-1]
                elif q_rev:
                    reverse_strand = True
                    db_start, db_end = db_end, db_start
                    bt = bt[::-1]
                elif t_rev:
                    reverse_strand = True
                out_row = bytearray(b"-" * min(q_start, q_end))
                seq_pos = 0
                for op in bt:
                    if op == "M":
                        c = tseq[db_start - seq_pos] if reverse_strand \
                            else tseq[db_start + seq_pos]
                        if reverse_strand:
                            c = bytes([c]).translate(COMPLEMENT)[0]
                        out_row.append(c)
                        seq_pos += 1
                    elif op == "I":
                        out_row += b"-"
                    else:  # D
                        seq_pos += 1
                out_row += b"-" * (q_len - (max(q_start, q_end) + 1))
                entry += bytes(out_row) + b"\n"
            w.write(query_key, bytes(entry))
    for r in {id(q): q, id(qh): qh, id(t): t, id(th): th, id(res): res
              }.values():
        r.close()
    return 0


def proteinaln2nucl(par, command):
    """Transform a protein-level alignment DB back to nucleotide
    coordinates, rescoring with the nucleotide matrix
    (reference src/util/proteinaln2nucl.cpp: coordinates *3, gap cost
    go + (cnt-1)*3*ge, backtrace run lengths *3, uncompressed output)."""
    from ..data.submat import get_submat
    from ..ops.evalue import EvalueComputation

    nq, nt, aq, at_, alnp, out = par.filenames[:6]
    same_db = nq == nt and aq == at_
    qn = DBReader(nq)
    tn = qn if same_db else DBReader(nt)
    qa = DBReader(aq)
    ta = qa if same_db else DBReader(at_)
    submat = get_submat(par.sub_mat.nucl, 1.0, 0.0)
    aa2num = submat.make_aa2num_table()
    S = submat.sub_matrix
    go, ge = par.gap_open.nucl, par.gap_extend.nucl
    evaluer = EvalueComputation(tn.total_residues(), submat, go, ge)
    aln = DBReader(alnp)
    with DBWriter(out, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed)) as w:
        for i in (int(x) for x in np.argsort(aln.offsets, kind="stable")):
            aln_key = aln.get_db_key(i)
            qid = qn.get_id(aln_key)
            if qid < 0:
                log.die(f"Invalid nucleotide query key {aln_key}.")
            nuc_q = qn.get_data(qid)
            nuc_q_len = qn.get_seq_len(qid)
            q_start_codon = qa.get_data_by_key(aln_key)[:1] == b"*"
            lines = []
            for line in aln.get_data(i).split(b"\n"):
                if not line:
                    continue
                f = line.split(b"\t")
                db_key = fast_atoi(f[0])
                q_start, q_end = int(f[4]), int(f[5])
                db_start, db_end = int(f[7]), int(f[8])
                bt = f[10].decode() if len(f) > 10 else ""
                if not bt:
                    log.die("This module only supports database input "
                            "with backtrace string")
                tid = tn.get_id(db_key)
                if tid < 0:
                    log.die(f"Invalid nucleotide target key {db_key}.")
                nuc_t = tn.get_data(tid)
                nuc_t_len = tn.get_seq_len(tid)
                t_start_codon = ta.get_data_by_key(db_key)[:1] == b"*"
                db_start = db_start * 3 + (-3 if t_start_codon else 0)
                db_end = db_end * 3 + 2 + (-3 if t_start_codon else 0)
                q_start = q_start * 3 + (-3 if q_start_codon else 0)
                q_end = q_end * 3 + 2 + (-3 if q_start_codon else 0)
                id_cnt = aln_len = 0
                q_pos, t_pos = q_start, db_start
                score = 0
                new_bt = []
                import re as _re
                for cnt_s, op in _re.findall(r"(\d*)([MID])", bt):
                    cnt = int(cnt_s) if cnt_s else 0
                    if op == "M":
                        for _ in range(cnt * 3):
                            id_cnt += int(nuc_q[q_pos] == nuc_t[t_pos])
                            score += int(S[aa2num[nuc_q[q_pos]],
                                           aa2num[nuc_t[t_pos]]])
                            q_pos += 1
                            t_pos += 1
                    elif op == "D":
                        t_pos += cnt * 3
                        score -= go + ((cnt - 1) * 3) * ge
                    else:
                        q_pos += cnt * 3
                        score -= go + ((cnt - 1) * 3) * ge
                    aln_len += cnt * 3
                    new_bt.append(f"{cnt * 3}{op}")
                from ..align import util as autil
                bits = int(evaluer.compute_bit_score(score))
                ev = evaluer.compute_evalue(score, nuc_q_len)
                seq_id = id_cnt / np.float32(aln_len)
                lines.append("\t".join([
                    str(db_key), str(bits), autil.fast_seq_id_str(seq_id),
                    autil.format_evalue(ev), str(q_start), str(q_end),
                    str(nuc_q_len), str(db_start), str(db_end),
                    str(nuc_t_len), "".join(new_bt)]) + "\n")
            w.write(aln_key, "".join(lines).encode())
    return 0
