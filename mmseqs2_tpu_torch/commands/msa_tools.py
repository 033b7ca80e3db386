"""MSA commands: result2msa (FASTA/a3m), msa2profile and the MSA/profile
tools (profile2pssm, profile2consensus, profile2repseq, convertca3m,
profile2neff, filtera3m, msa2result).

Port of mmseqs2_tpu/commands/msa_tools.py. Reference:
src/util/result2msa.cpp (format modes 2/5/6), src/util/msa2profile.cpp
(match-mode column masking + PSSM). result2msa aligns the hits without a
backtrace again over a block of queries in one Aligner.align_batch (the
`sw_multi` kernel on the card), where the JAX package calls align_query
once a query; a pair's alignment does not depend on its batch, so the
bytes are the same. The rest is host code.
"""

import os
import time

import numpy as np

from ..align import aligner as aligner_mod
from ..align.aligner import Aligner, SCORE_COV_SEQID
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops import sw
from ..ops.evalue import EvalueComputation
from ..profile import filter as msafilter
from ..profile import msa as msamod
from ..profile import pssm as pssmmod
from ..utils import log
from .common import EncodedDB, fast_atoi, get_sub_mat, open_seq_db
from .convertalis import parse_fasta_header
from .result2profile import expand_cigar, global_bias_correct

GAP = msamod.GAP
# queries whose hits without a backtrace go through one align_batch (as
# align_cmd.BLOCK: one scan a shape group; bigger blocks fill the 16k-lane
# launches better)
BLOCK = 256

# result2msa: queries, the hits aligned again (no backtrace in the result
# DB), the align_batch calls, the sw_multi launches by form and the
# aligner's read-backs they made, the kernels' device milliseconds (CUDA
# events; 0 on the CPU), the seconds of the realignment and of the rest
# (parsing, MSA, filter, emission, write)
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(queries=0, pairs=0, batches=0, launches=0,
                 launches_by_form={"int16": 0, "int32": 0}, readbacks=0,
                 kernel_ms=0.0, align_s=0.0, host_s=0.0)


reset_stats()


def _parse_hits(query_key, data, same_db):
    """A query's hits with expanded backtraces, and the indices of those
    without one (result2msa.cpp:227-258)."""
    hits = []
    need = []
    for line in data.split(b"\n"):
        if not line:
            continue
        parts = line.split(b"\t")
        key = fast_atoi(parts[0])
        if key == query_key and same_db:
            continue
        h = {
            "db_key": key,
            "q_start": int(parts[4]) if len(parts) > 4 else 0,
            "db_start": int(parts[7]) if len(parts) > 7 else 0,
            "backtrace": expand_cigar(parts[10].decode())
            if len(parts) > 10 else "",
            # mode 6 appends the record columns after the name; without a
            # backtrace resultToBuffer re-renders the 10-col form
            "aln_info": b"\t".join(parts[1:10]) if len(parts) >= 10
            else b"",
        }
        if not h["backtrace"]:
            need.append(len(hits))
        hits.append(h)
    return hits, need


def _realign(aligner, tdb, treader, block):
    """SW once more for every hit without a backtrace of a block of queries
    (dicts with "ctx", "hits", "need"), in one Aligner.align_batch:
    SCORE_COV_SEQID, no thresholds, as the JAX package's align_query of
    each query."""
    jobs, owners = [], []
    for q in block:
        if not q["need"]:
            continue
        keys = [q["hits"][i]["db_key"] for i in q["need"]]
        tids = [treader.get_id(k) for k in keys]
        jobs.append((q["ctx"], keys, [tdb.seq_num(t) for t in tids],
                     [tdb.seq_len(t) for t in tids], [False] * len(keys)))
        owners.append(q)
    if not jobs:
        return
    st = aligner_mod.STATS
    before = (sw.sw_multi.launches, dict(sw.sw_multi.form_launches),
              st["readbacks"], st["kernel_ms"])
    t0 = time.perf_counter()
    results = aligner.align_batch(jobs, SCORE_COV_SEQID, 0, 0.0,
                                  np.finfo(np.float64).max)
    STATS["align_s"] += time.perf_counter() - t0
    STATS["batches"] += 1
    STATS["pairs"] += sum(len(j[1]) for j in jobs)
    STATS["launches"] += sw.sw_multi.launches - before[0]
    for form, n in sw.sw_multi.form_launches.items():
        STATS["launches_by_form"][form] += n - before[1][form]
    STATS["readbacks"] += st["readbacks"] - before[2]
    STATS["kernel_ms"] += st["kernel_ms"] - before[3]
    for q, res_list in zip(owners, results):
        for i, res in zip(q["need"], res_list):
            h = q["hits"][i]
            h["q_start"] = res.q_start
            h["db_start"] = res.db_start
            h["backtrace"] = res.backtrace
            line = res.to_line(False).rstrip("\n")
            h["aln_info"] = line.split("\t", 1)[1].encode() \
                if "\t" in line else b""


def _letters(num2aa):
    """Numeric MSA letter -> ASCII byte; GAP and above -> '-'."""
    lut = np.full(256, ord("-"), np.uint8)
    lut[:GAP] = [ord(num2aa[c]) for c in range(GAP)]
    return lut


class _Hit:
    pass


def result2msa(par, command):
    qdb_path, tdb_path, res_path, out_path = par.filenames[:4]
    mode = par.msa_format_mode
    if mode in (0, 1):
        # reference rejects CA3M output unconditionally (the emission code
        # below its gate is unreachable); result2msa.cpp:41-44
        log.error("Cannot use result2msa with indexed target database "
                  "for CA3M output")
        return 1
    if mode not in (2, 3, 4, 5, 6):
        log.die(f"--msa-format-mode {mode} is not implemented "
                f"(supported: 2 FASTA, 3 FASTA+summary, 4 STOCKHOLM flat, "
                f"5/6 a3m; binary ca3m via convertca3m)")
    same_db = qdb_path == tdb_path
    # result2msa.cpp:21 forces --filter-msa off unless explicitly set
    if not par.was_set("filter_msa"):
        par.set("filter_msa", 0)
    submat = get_sub_mat(par)
    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    qh = DBReader(qdb_path + "_h")
    th = qh if same_db else DBReader(tdb_path + "_h")
    res = DBReader(res_path)

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)
    qid = int(float(par.qid.split(",")[0]) * 100)
    num2aa = submat.num2aa
    letters = _letters(num2aa)

    # LINEAR_ACCCESS iteration (result2msa.cpp:99): offset order, a block
    # of queries at a time
    order = [int(x) for x in np.argsort(res.offsets, kind="stable")]
    with DBWriter(out_path, dbt.DBTYPE_MSA_DB) as w:
        for b0 in range(0, len(order), BLOCK):
            t0 = time.perf_counter()
            block = []
            for i in order[b0:b0 + BLOCK]:
                query_key = res.get_db_key(i)
                q_num = qdb.seq_num(qreader.get_id(query_key))
                hits, need = _parse_hits(query_key, res.get_data(i),
                                         same_db)
                block.append(dict(key=query_key, q_num=q_num, hits=hits,
                                  need=need, ctx=aligner.init_query(q_num)
                                  if need else None))
            t1 = time.perf_counter()
            _realign(aligner, tdb, treader, block)
            t2 = time.perf_counter()
            for q in block:
                _write_msa(par, mode, w, q["key"], q["q_num"], q["hits"],
                           tdb, treader, qh, th, submat, qid, letters)
            STATS["queries"] += len(block)
            STATS["host_s"] += (t1 - t0) + (time.perf_counter() - t2)
    if mode == 4:
        for suf in (".index", ".dbtype"):
            if os.path.exists(out_path + suf):
                os.unlink(out_path + suf)
    return 0


def _write_msa(par, mode, w, query_key, q_num, hits, tdb, treader, qh, th,
               submat, qid, letters):
    """One query's MSA entry (result2msa.cpp:260-540)."""
    num2aa = submat.num2aa
    edge_seqs = [tdb.seq_num(treader.get_id(h["db_key"])) for h in hits]
    alns = []
    for h in hits:
        a = _Hit()
        a.q_start = h["q_start"]
        a.db_start = h["db_start"]
        a.backtrace = h["backtrace"]
        alns.append(a)
    if par.allow_deletion:
        # rows may exceed the center length; emission and the MSA
        # filter read only centerLength columns (result2msa.cpp:260)
        msa = msamod.compute_msa_del(q_num, edge_seqs, alns)[:, :len(q_num)]
    else:
        msa = msamod.compute_msa_nodel(q_num, edge_seqs, alns)
    set_size, center_len = msa.shape
    if par.filter_msa:
        kept_idx, _ = msafilter.filter_msa(
            msa, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
            par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
            par.filter_min_enable)
        kept = (kept_idx if kept_idx.dtype == bool
                else np.isin(np.arange(set_size), kept_idx))
    else:
        kept = np.ones(set_size, dtype=bool)

    # header kept WITH its trailing newline (entryLen-1)
    center_header = qh.get_data(qh.get_id(query_key))
    out = []
    if mode == 3:
        # FASTA + header summary line (result2msa.cpp:267-289)
        from .misc_tools import _uniprot_summarize
        headers = []
        for k in range(set_size):
            if k == 0:
                headers.append(center_header.decode().rstrip("\n"))
            elif kept[k]:
                t_key = hits[k - 1]["db_key"]
                headers.append(th.get_data(th.get_id(t_key))
                               .decode().rstrip("\n"))
        out.append(f"#{par.summary_prefix}-{query_key}|"
                   f"{_uniprot_summarize(headers)}\n".encode())
    if mode == 4:
        out.append(b"# STOCKHOLM 1.0\n")
        if par.skip_query:
            out.append(b"#=GF ID " + parse_fasta_header(
                center_header.split(b"\n")[0].decode()).encode() + b"\n")
    start = 1 if par.skip_query else 0
    for k in range(start, set_size):
        if not kept[k]:
            continue
        row = msa[k]
        only_gap = bool((row == GAP).all())
        if k == 0:
            header = center_header
        else:
            t_key = hits[k - 1]["db_key"]
            header = th.get_data(th.get_id(t_key))
        if mode == 4:
            # STOCKHOLM row: accession + space + row
            name = ("DUMMY" if only_gap
                    else parse_fasta_header(header.split(b"\n")[0]
                                            .decode()))
            out.append(name.encode() + b" ")
            out.append(letters[row].tobytes())
            out.append(b"\n")
        elif mode in (2, 3):
            out.append(b">" + (b"DUMMY\n" if only_gap else header))
            out.append(letters[row].tobytes())
            out.append(b"\n")
        else:                   # a3m (5/6)
            name = ("DUMMY" if only_gap
                    else parse_fasta_header(header.split(b"\n")[0]
                                            .decode()))
            out.append(b">" + name.encode())
            if mode == 6 and k > 0:
                # alignment record columns after the accession
                # (result2msa.cpp:427-432)
                out.append(b"\t" + hits[k - 1]["aln_info"])
            out.append(b"\n")
            if k == 0:
                out.append(letters[row].tobytes())
                out.append(b"\n")
            else:
                h = hits[k - 1]
                seq = edge_seqs[k - 1]
                bt = h["backtrace"]
                bt_pos = 0
                seq_pos = 0
                buf = bytearray()
                for pos in range(center_len):
                    c = row[pos]
                    if c >= GAP:
                        buf.append(ord("-"))
                    else:
                        buf.append(ord(num2aa[c]))
                        bt_pos += 1
                        seq_pos += 1
                    while bt_pos < len(bt) and bt[bt_pos] == "I":
                        bt_pos += 1
                    while bt_pos < len(bt) and bt[bt_pos] == "D":
                        buf.append(ord(num2aa[
                            seq[h["db_start"] + seq_pos]].lower()))
                        bt_pos += 1
                        seq_pos += 1
                out.append(bytes(buf))
                out.append(b"\n")
    if mode == 4:
        out.append(b"//\n")
        # STOCKHOLM is a flat file: entries without null bytes,
        # index/dbtype removed after close (result2msa.cpp:541-543)
        w.write(query_key, b"".join(out), add_null=False)
    else:
        w.write(query_key, b"".join(out))


def _parse_fasta_msa(text: bytes):
    """kseq-style FASTA parsing -> list of (name, full_header, sequence)."""
    entries = []
    name = None
    header = None
    seq = []
    for line in text.split(b"\n"):
        if line.startswith(b">"):
            if name is not None:
                entries.append((name, header, b"".join(seq)))
            header = line[1:]
            name = header.split()[0] if header.split() else b""
            seq = []
        elif line:
            seq.append(line.strip())
    if name is not None:
        entries.append((name, header, b"".join(seq)))
    return entries


def msa2profile(par, command):
    """MSA DB -> profile DB (msa2profile.cpp): pick match columns (by the
    first sequence or by weighted gap fraction), filter, compute the PSSM."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    submat = get_sub_mat(par)
    mask_by_first = par.match_mode == 0
    match_ratio = np.float32(par.match_ratio)
    enc = submat.make_aa2num_table()
    qid = int(float(par.qid.split(",")[0]) * 100)

    with DBWriter(out_path, dbt.DBTYPE_HMM_PROFILE) as w, \
            DBWriter(out_path + "_h", dbt.DBTYPE_GENERIC_DB) as wh:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            data = reader.get_data(i)
            if data.startswith(b"#"):          # comment line breaks kseq
                nl = data.find(b"\n")
                data = data[nl + 1:] if nl >= 0 else b""
            entries = _parse_fasta_msa(data)
            if par.skip_query and entries:
                entries = entries[1:]
            if par.msa_type in (0, 1):
                entries = [e for e in entries
                           if not e[0].startswith(b"ss_")]
            if not entries:
                log.warning(f"Empty msa {i}! Skipping entry.")
                continue

            center_gapped = entries[0][2]
            L_gap = len(center_gapped)
            wh.write(key, entries[0][1] + b"\n")

            rows = []
            for name, header, s in entries:
                if par.msa_type == 1:
                    s = bytes(c for c in s if not (97 <= c <= 122))
                row = np.where(np.frombuffer(s, np.uint8) == ord("-"),
                               np.uint8(GAP),
                               enc[np.frombuffer(s, np.uint8)])
                rows.append(row[:L_gap])
            msa = np.vstack([np.pad(r, (0, L_gap - len(r)),
                                    constant_values=GAP) for r in rows])

            if mask_by_first:
                masked = msa[0] == GAP
            else:
                sw = pssmmod.compute_sequence_weights(msa)
                sw = pssmmod.normalize_to_1(sw)
                X = msa.astype(np.int32).copy()
                for k in range(len(X)):
                    row = X[k]
                    j = 0
                    while j < L_gap and row[j] == GAP:
                        row[j] = msamod.ENDGAP
                        j += 1
                    j = L_gap - 1
                    while j >= 0 and row[j] == GAP:
                        row[j] = msamod.ENDGAP
                        j -= 1
                res_w = np.zeros(L_gap, dtype=np.float32)
                gap_w = np.zeros(L_gap, dtype=np.float32)
                for k in range(len(X)):
                    isres = X[k] < GAP
                    isgap = (X[k] == GAP)
                    res_w = (res_w + np.where(isres, sw[k], np.float32(0.0))
                             ).astype(np.float32)
                    gap_w = (gap_w + np.where(isgap, sw[k], np.float32(0.0))
                             ).astype(np.float32)
                with np.errstate(invalid="ignore"):
                    frac = gap_w / (res_w + gap_w)
                masked = frac > match_ratio
            msa = msa[:, ~masked]

            set_size, center_len = msa.shape
            if par.filter_msa == 1:
                kept, _ = msafilter.filter_msa(
                    msa, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
                    par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
                    par.filter_min_enable)
                msa_f = msa[kept]
            else:
                msa_f = msa
            out = pssmmod.compute_pssm_from_msa(msa_f, submat, par.wg)
            pssm = out["pssm"]
            if par.comp_bias_corr:
                pssm = global_bias_correct(pssm, submat)
            payload = pssmmod.profile_to_buffer(
                pssm, msa[0], out["consensus"], out["neff"], submat.aa2num)
            w.write(key, payload)
    return 0


def profile2pssm(par, command):
    """Render profile DBs as a PSSM table (profile2pssm.cpp)."""
    from ..profile.io import alignment_profile, parse_profile

    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    submat = get_sub_mat(par)
    num2aa = submat.num2aa
    is_db = par.db_output
    order = np.argsort(reader.offsets, kind="stable")
    w = DBWriter(out_path, dbt.DBTYPE_GENERIC_DB) if is_db else None
    flat = open(out_path, "w") if not is_db else None
    for i in order:
        key = reader.get_db_key(int(i))
        p = parse_profile(reader.get_data(int(i)))
        prof = alignment_profile(p)[:20]      # (20, L) pssm/4
        out = []
        if not is_db:
            out.append(f"Query profile of sequence {key}\n")
        out.append("Pos\tCns")
        for aa in range(20):
            out.append("\t" + num2aa[aa])
        out.append("\n")
        for j in range(p.length):
            out.append(f"{j}\t{num2aa[p.consensus_num[j]]}")
            for aa in range(20):
                out.append(f"\t{prof[aa, j]}")
            out.append("\n")
        payload = "".join(out)
        if is_db:
            w.write(key, payload.encode())
        else:
            flat.write(payload)
    if is_db:
        w.close()
    else:
        flat.close()
    return 0


def _profile2seq(par, consensus: bool):
    from ..profile.io import parse_profile

    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    submat = get_sub_mat(par)
    num2aa = submat.num2aa
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, dbt.DBTYPE_AMINO_ACIDS) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            p = parse_profile(reader.get_data(int(i)))
            src = p.consensus_num if consensus else p.query_num
            w.write(key, bytes(ord(num2aa[c]) for c in src) + b"\n")
    for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source"):
        srcf, dst = in_path + suf, out_path + suf
        if os.path.exists(srcf) and not os.path.lexists(dst):
            os.symlink(os.path.abspath(srcf), dst)
    return 0


def profile2consensus(par, command):
    """Extract consensus sequences from a profile DB."""
    return _profile2seq(par, True)


def profile2repseq(par, command):
    """Extract the representative (query) sequences from a profile DB."""
    return _profile2seq(par, False)


def convertca3m(par, command):
    """Convert a cA3M DB into an alignment-result DB
    (reference src/util/convertca3m.cpp: extractMatcherResults with
    skipFirst=true, then Matcher::resultToBuffer with backtrace).

    Usage: convertca3m <ca3mDB> <resultDB>
    """
    from ..align.aligner import AlnResult
    from ..profile.ca3m import extract_matcher_results

    ca3m, out = par.filenames[:2]
    with DBReader(ca3m + "_ca3m.ffdata", ca3m + "_ca3m.ffindex") as r, \
            DBReader(ca3m + "_sequence.ffdata",
                     ca3m + "_sequence.ffindex") as seqs, \
            DBWriter(out, dbt.DBTYPE_CA3M_DB,
                     compressed=bool(par.compressed)) as w:
        for i in r.linear_order():
            key, results = extract_matcher_results(
                r.get_data(int(i)), seqs, skip_first=True)
            lines = []
            for h in results:
                res = AlnResult(
                    db_key=h["db_key"], score=0, raw_score=0, seq_id=0.0,
                    eval=0.0, q_start=h["q_start"], q_end=h["q_end"],
                    q_len=h["q_len"], db_start=h["db_start"],
                    db_end=h["db_end"], db_len=h["db_len"],
                    backtrace=h["backtrace"])
                lines.append(res.to_line(add_backtrace=True))
            w.write(key, "".join(lines).encode())
    return 0


def profile2neff(par, command):
    """Per-position Neff_M values of a profile DB
    (reference src/util/profile2neff.cpp): flat text by default
    ('Neff_Ms of sequence <key>' header line + tab-separated %.4f row),
    or a DB with --db-output."""
    from ..profile.io import parse_profile

    db, out = par.filenames[:2]
    is_db = bool(par.db_output)
    reader = DBReader(db)
    writer = DBWriter(out, dbt.DBTYPE_GENERIC_DB,
                      compressed=bool(par.compressed and is_db)) \
        if is_db else open(out, "w")
    order = np.argsort(reader.offsets, kind="stable")
    for i in order:
        i = int(i)
        key = reader.get_db_key(i)
        p = parse_profile(reader.get_data(i))
        row = "\t".join(f"{v:0.4f}" for v in p.neff) + "\n"
        if is_db:
            writer.write(key, row.encode())
        else:
            writer.write(f"Neff_Ms of sequence {key}\n" + row)
    writer.close()
    reader.close()
    return 0


def filtera3m(par, command):
    """Filter an A3M flat file with the MsaFilter and write surviving
    records (reference src/util/filtera3m.cpp). Lowercase insertion columns
    are ignored for filtering but preserved in the output."""
    from ..profile.msa import GAP as MSA_GAP

    in_path, out_path = par.filenames[:2]
    submat = get_sub_mat(par)
    aa2num = submat.make_aa2num_table()
    records = []
    with open(in_path, "rb") as f:
        name = None
        seqp = []
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    records.append((name, b"".join(seqp)))
                name = line[1:].rstrip(b"\n")
                seqp = []
            else:
                seqp.append(line.strip())
        if name is not None:
            records.append((name, b"".join(seqp)))
    if not records:
        open(out_path, "w").close()
        return 0
    center_len = len(records[0][1])
    rows = np.full((len(records), center_len), MSA_GAP, dtype=np.int32)
    for k, (_, seq) in enumerate(records):
        arr = np.frombuffer(seq, dtype=np.uint8)
        arr = arr[~((arr >= ord("a")) & (arr <= ord("z")))][:center_len]
        row = np.where(arr == ord("-"), MSA_GAP,
                       aa2num[arr].astype(np.int32))
        rows[k, :len(row)] = row
    qid = int(float(par.qid.split(",")[0]) * 100)
    kept, _ = msafilter.filter_msa(
        rows, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
        par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
        par.filter_min_enable)
    with open(out_path, "wb") as f:
        for k in np.nonzero(kept)[0]:
            name, seq = records[k]
            f.write(b">" + name + b"\n" + seq + b"\n")
    return 0


def _rescore_backtrace(q_ascii, t_ascii, submat, aa2num, evaluer,
                       gap_open, gap_ext, res):
    """Delegates to align.util.rescore_backtrace (Matcher.cpp:331-399)."""
    from ..align.util import rescore_backtrace
    return rescore_backtrace(q_ascii.encode(), t_ascii.encode(),
                             submat.make_aa2num_table(), submat.sub_matrix,
                             evaluer, gap_open, gap_ext, res)


def _msa_record_count(data: bytes) -> int:
    """msa2result.cpp:84-118 prescan state machine over the entry INCLUDING
    its '\\0' terminator — the terminator counts as a residue, so the result
    is the true record count + 1 (a reference quirk the output keys bake in).
    """
    in_header = False
    set_size = 0
    seq_len = 0
    for c in data + b"\0":
        if c == 0x3E:  # '>'
            seq_len = 0
            in_header = True
            set_size += 1
        elif c == 0x0A:
            in_header = False
        elif not in_header:
            seq_len += 1
    if not in_header and seq_len > 0:
        set_size += 1
    return set_size


def msa2result(par, command):
    """Convert an MSA DB into a member sequence DB + per-member alignment
    results against the MSA consensus (reference src/util/msa2result.cpp).
    Member keys are running indices offset by the prescan record counts;
    results are rescored along the gap-free consensus/member backtrace with
    a bias -0.2 matrix and an MSA-count E-value context."""
    from ..align.aligner import AlnResult
    from ..align import util as autil
    from ..data.submat import get_submat

    in_path, seq_out, res_out = par.filenames[:3]
    submat = get_submat(par.sub_mat.aa, 2.0, -0.2)
    enc = submat.make_aa2num_table()
    qid = int(float(par.qid.split(",")[0]) * 100)
    reader = DBReader(in_path)
    order = [int(x) for x in reader.linear_order()]
    counts = [_msa_record_count(reader.get_data(i)) for i in order]
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])]) \
        if counts else np.zeros(1)
    evaluer = EvalueComputation(reader.size, submat,
                                par.gap_open.aa, par.gap_extend.aa)
    match_ratio = np.float32(par.match_ratio)

    sw = DBWriter(seq_out, dbt.DBTYPE_AMINO_ACIDS,
                  compressed=bool(par.compressed))
    hw = DBWriter(seq_out + "_h", dbt.DBTYPE_GENERIC_DB,
                  compressed=bool(par.compressed))
    rw = DBWriter(res_out, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed))
    for oi, i in enumerate(order):
        key = reader.get_db_key(i)
        data = reader.get_data(i)
        if par.msa_type == 0:
            from ..profile.ca3m import extract_a3m
            with DBReader(in_path + "_sequence.ffdata",
                          in_path + "_sequence.ffindex") as sr, \
                    DBReader(in_path + "_header.ffdata",
                             in_path + "_header.ffindex") as hr:
                data = extract_a3m(data, sr, hr)
        if data.startswith(b"#"):
            nl = data.find(b"\n")
            data = data[nl + 1:] if nl >= 0 else b""
        entries = _parse_fasta_msa(data)
        if par.skip_query and entries:
            entries = entries[1:]
        start_key = int(offsets[oi])
        rows = []
        center_gap_len = 0
        fasta_error = False
        written = 0
        for name, header, s in entries:
            if not name or not s:
                log.warning(f"Invalid fasta sequence {written} in entry "
                            f"{key}")
                fasta_error = True
                break
            if par.msa_type in (0, 1) and name.startswith(b"ss_"):
                continue
            hw.write(start_key + written, header + b"\n")
            sw.write(start_key + written,
                     bytes(c for c in s if c != ord("-")) + b"\n")
            written += 1
            if not rows:
                center_gap_len = len(s)
            arr = np.frombuffer(s, np.uint8)
            if par.msa_type == 1:
                arr = arr[~((arr >= ord("a")) & (arr <= ord("z")))]
            arr = arr[:center_gap_len]
            row = np.where(arr == ord("-"), np.int32(GAP),
                           enc[arr].astype(np.int32))
            rows.append(np.pad(row, (0, center_gap_len - len(row)),
                               constant_values=GAP))
        if fasta_error:
            log.warning(f"Invalid msa {i}! Skipping entry.")
            continue
        if not rows:
            log.warning(f"Empty msa {i}! Skipping entry.")
            continue
        msa = np.vstack(rows)
        L_gap = center_gap_len
        if par.match_mode == 0:
            # reference reads uninitialized maskedColumns in this mode
            # (msa2result.cpp:293-303 commented out) — treat as no masking
            masked = np.zeros(L_gap, dtype=bool)
        else:
            w_ = pssmmod.normalize_to_1(pssmmod.compute_sequence_weights(msa))
            X = msa.copy()
            for k in range(len(X)):
                j = 0
                while j < L_gap and X[k, j] == GAP:
                    X[k, j] = msamod.ENDGAP
                    j += 1
                j = L_gap - 1
                while j >= 0 and X[k, j] == GAP:
                    X[k, j] = msamod.ENDGAP
                    j -= 1
            res_w = np.zeros(L_gap, np.float32)
            gap_w = np.zeros(L_gap, np.float32)
            for k in range(len(X)):
                res_w = (res_w + np.where(X[k] < GAP, w_[k],
                                          np.float32(0))).astype(np.float32)
                gap_w = (gap_w + np.where(X[k] == GAP, w_[k],
                                          np.float32(0))).astype(np.float32)
            with np.errstate(invalid="ignore"):
                masked = (gap_w / (res_w + gap_w)) > match_ratio
            masked = np.where(np.isnan(gap_w / (res_w + gap_w)), False,
                              masked)
        compact = msa[:, ~masked]
        row_order = list(range(len(msa)))
        if par.filter_msa == 1:
            kept, _ = msafilter.filter_msa(
                compact, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
                par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
                par.filter_min_enable)
            pssm_in = compact[kept]
            # MsaFilter::shuffleSequences swap-compacts kept rows to the
            # front IN PLACE (MsaFilter.cpp:557-568); the result loop below
            # then keys rows by their shuffled position — reproduce the
            # exact swap permutation
            i = 0
            for j in range(len(row_order)):
                if kept[j]:
                    if i < j:
                        row_order[i], row_order[j] = \
                            row_order[j], row_order[i]
                    i += 1
        else:
            pssm_in = compact
        out = pssmmod.compute_pssm_from_msa(pssm_in, submat, par.wg)
        consensus = bytes(out["consensus"])
        lines = []
        num2aa = submat.num2aa
        for k, row_k in enumerate(row_order):
            bt = []
            cons_ng = []
            curr_ng = []
            n_ident = 0
            cur_col = 0
            for j in range(L_gap):
                if masked[j]:
                    con = "-"
                else:
                    con = chr(consensus[cur_col])
                    cur_col += 1
                v = int(msa[row_k, j])
                sr = "-" if v == GAP else num2aa[v]
                if con == "-" and sr == "-":
                    continue
                if con != "-" and sr == "-":
                    bt.append("I")
                    cons_ng.append(con)
                elif con == "-":
                    bt.append("D")
                    curr_ng.append(sr)
                else:
                    bt.append("M")
                    curr_ng.append(sr)
                    cons_ng.append(con)
                n_ident += int(con == sr)
            bts = "".join(bt)
            cons_s = "".join(cons_ng)
            curr_s = "".join(curr_ng)
            res = AlnResult(
                db_key=start_key + k, score=0, raw_score=0,
                seq_id=n_ident / np.float32(len(bts)) if bts else 0.0,
                eval=0.0, q_start=0, q_end=len(cons_s) - 1,
                q_len=len(cons_s), db_start=0, db_end=len(curr_s) - 1,
                db_len=len(curr_s), aln_length=len(bts), backtrace=bts)
            _rescore_backtrace(cons_s, curr_s, submat, submat.aa2num,
                               evaluer, par.gap_open.aa, par.gap_extend.aa,
                               res)
            lines.append(autil.result_to_line(res, True))
        rw.write(key, "".join(lines).encode())
    rw.close()
    hw.close()
    sw.close()
    for suf in (".lookup", ".source"):
        if os.path.exists(in_path + suf) and \
                not os.path.lexists(seq_out + suf):
            os.symlink(os.path.abspath(in_path + suf), seq_out + suf)
    reader.close()
    return 0
