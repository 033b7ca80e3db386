"""`align2clust` — fused alignment + incremental clustering.

Reference: src/alignment/Align2clust.cpp (the linclust-v2
fast path). Semantics reproduced:
  - representatives processed in pref-list-size order (desc, id asc) for
    SET_COVER (cluster-mode 0), input order otherwise
    (Align2clust.cpp:498-520 PrefInfo::compareBySizeAndId);
  - an already-assigned representative is skipped; assigned targets are
    never re-claimed (incremental greedy assignment);
  - per hit: identity accepted directly; ungapped rescore on the prefilter
    diagonal gated by evalue/aln-len/coverage/seq-id (:660-675); failures
    above the precision-library score-per-column threshold
    (:440 parsePrecisionLib, 0.99 precision) escalate to a gapped alignment
    seeded at a 3-consecutive-match anchor (:787-816);
  - optional --filter-clu-db-file/--filter-seq-db-file all-member gate:
    the target joins only if EVERY member of its old cluster also aligns
    to the representative (:683-760);
  - optional alignment output at <outDB>_aln with --include-align-files
    (identity/ungapped hits as all-M records, gapped hits with backtrace).

Architectural divergence (documented): the reference interleaves a lock-free
cluster thread with per-pair block-aligner calls; we process representatives
sequentially, deterministic, and each gapped escalation is one
`Aligner.align_query` call (the SW kernel `sw_multi` on the card, two
launches and two read-backs a call). The rust block-aligner is replaced by
the parity-proven SW aligner (same substitution scores and gates).

Port of mmseqs2_tpu/commands/align2clust.py. `STATS` counts the calls.
"""

import numpy as np

from ..align import util as autil
from ..align.aligner import Aligner, AlnResult, SCORE_COV_SEQID
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..utils import log
from .align_cmd import check_criteria
from .common import EncodedDB, get_sub_mat, open_seq_db, \
    parse_prefilter_entry
from .rescorediagonal import (ascii_submat, diagonal_window, local_best,
                              parse_precision_lib)

SET_COVER = 0

# Counters summed over every run until reset_stats(): representatives
# processed, candidate hits examined, hits accepted by the ungapped rescore
# and by the gapped fallback, and the gapped fallback's Aligner.align_query
# calls (each one (query, target) pair).
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(reps=0, hits=0, ungapped_accepted=0, gapped_accepted=0,
                 gapped_calls=0)


reset_stats()


def _ungapped(amat, q_seq, t_seq, diag, evaluer, q_len, t_len, seq_id_mode):
    """BlockAligner::ungappedAlign equivalent: best run on the diagonal."""
    win = diagonal_window(q_len, t_len, diag)
    if win is None:
        return None
    qs, ts, n, d = win
    col = amat[q_seq[qs:qs + n], t_seq[ts:ts + n]]
    score, start, end = local_best(col)
    if d >= 0:
        q_s, q_e, t_s, t_e = start + qs, end + qs, start, end
    else:
        q_s, q_e, t_s, t_e = start, end, start + ts, end + ts
    aln_len = end - start + 1
    ev = evaluer.compute_evalue(score, q_len)
    upper_q = q_seq[q_s:q_e + 1] & ~np.uint8(0x20)
    upper_t = t_seq[t_s:t_e + 1] & ~np.uint8(0x20)
    id_cnt = int((upper_q == upper_t).sum())
    seq_id = autil.compute_seq_id(seq_id_mode, id_cnt, q_len, t_len, aln_len)
    return {
        "score": score, "eval": ev, "aln_len": aln_len, "diag_len": n,
        "q_start": q_s, "q_end": q_e, "t_start": t_s, "t_end": t_e,
        "qcov": autil.compute_cov(q_s, q_e, q_len),
        "tcov": autil.compute_cov(t_s, t_e, t_len),
        "seq_id": float(seq_id),
    }


def _passes(u, par):
    return (u["eval"] <= par.evalue
            and u["aln_len"] >= par.min_aln_len
            and autil.has_coverage(par.cov_thr, par.cov_mode, u["qcov"],
                                   u["tcov"])
            and u["seq_id"] >= par.min_seq_id - np.finfo(np.float32).eps)


def _has_seed(q_seq, t_seq, u):
    """3-consecutive-identical-residue anchor inside the ungapped window."""
    qs, ts, n = u["q_start"], u["t_start"], u["aln_len"]
    if n < 3:
        return False
    eq = q_seq[qs:qs + n] == t_seq[ts:ts + n]
    return bool(np.any(eq[:-2] & eq[1:-1] & eq[2:]))


def _ungapped_result(key, u, q_len, t_len, score_bits, add_bt):
    return AlnResult(
        db_key=key, score=score_bits, raw_score=u["score"],
        seq_id=u["seq_id"], eval=u["eval"],
        q_start=u["q_start"], q_end=u["q_end"], q_len=q_len,
        db_start=u["t_start"], db_end=u["t_end"], db_len=t_len,
        qcov=u["qcov"], dbcov=u["tcov"], aln_length=u["aln_len"],
        backtrace="M" * u["aln_len"] if add_bt else "")


def align2clust(par, command):
    seq_path, res_path, out_path = par.filenames[:3]
    submat = get_sub_mat(par)
    reader = open_seq_db(seq_path)
    seqdb = EncodedDB(reader, submat)
    res = DBReader(res_path)
    amat = ascii_submat(submat)
    evaluer = EvalueComputation(reader.total_residues(), submat, 0, 0)
    gapped_evaluer = EvalueComputation(reader.total_residues(), submat,
                                       par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa,
                      gapped_evaluer, par.comp_bias_corr,
                      par.comp_bias_corr_scale)
    from ..data import precision_libs
    lib = (precision_libs.COV_SEQID_QSC_MINDIAG if par.cov_mode == 0
           else precision_libs.COV_SEQID_QSC_MINDIAG_TARGETCOV)
    spc_thr = parse_precision_lib(lib, par.min_seq_id, par.cov_thr, 0.99)
    log.info(f"Score per column threshold for filtering: {spc_thr}")

    clu_db = clu_seq = None
    if par.filter_clu_db_file and par.filter_seq_db_file:
        clu_db = DBReader(par.filter_clu_db_file)
        clu_seq = open_seq_db(par.filter_seq_db_file)

    include_aln = bool(par.include_align_files)
    add_bt = bool(par.add_backtrace)
    if include_aln and not add_bt:
        log.die("Writing alignment files requires backtrace (-a 1) and "
                "score+cov+seqid alignment")

    # representative order
    order = list(range(reader.size))
    if par.cluster_mode == SET_COVER:
        sizes = []
        for i in range(reader.size):
            rid = res.get_id(reader.get_db_key(i))
            data = res.get_data(rid) if rid >= 0 else b""
            sizes.append(max(1, data.count(b"\n")) if data.strip() else 1)
        order.sort(key=lambda i: (-sizes[i], i))

    assigned = {}
    clusters = {}          # rep key -> member keys (rep first)
    aln_out = {}
    for i in order:
        rep_key = reader.get_db_key(i)
        if i in assigned:
            continue
        STATS["reps"] += 1
        rid = res.get_id(rep_key)
        data = res.get_data(rid) if rid >= 0 else b""
        hit_keys, _, hit_diags = parse_prefilter_entry(data)
        q_num = seqdb.seq_num(i)
        q_seq = np.frombuffer(reader.get_seq(i), np.uint8)
        q_len = len(q_seq)
        ctx = None
        members = []
        records = []

        def member_gate_ok(t_key, base_diag):
            """--filter-clu all-member gate; returns (ok, staged records)."""
            if clu_db is None:
                return True, []
            cid = clu_db.get_id(t_key)
            if cid < 0:
                return True, []
            staged = []
            for line in clu_db.get_data(cid).split(b"\n"):
                if not line.strip():
                    continue
                ekey = int(line.split()[0])
                if ekey == t_key:
                    continue
                eid = clu_seq.get_id(ekey)
                e_seq = np.frombuffer(clu_seq.get_seq(eid), np.uint8)
                e_len = len(e_seq)
                if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                            float(q_len), float(e_len)):
                    return False, []
                ue = _ungapped(amat, q_seq, e_seq, base_diag, evaluer,
                               q_len, e_len, par.seq_id_mode)
                if ue is not None and _passes(ue, par):
                    if include_aln:
                        bits = int(evaluer.compute_bit_score(ue["score"])
                                   + 0.5)
                        staged.append(_ungapped_result(
                            ekey, ue, q_len, e_len, bits, add_bt))
                    continue
                nonlocal ctx
                if ctx is None:
                    ctx = aligner.init_query(q_num)
                e_num = submat.encode(clu_seq.get_seq(eid))
                STATS["gapped_calls"] += 1
                r = aligner.align_query(
                    ctx, [ekey], [e_num], [e_len], [False],
                    mode=SCORE_COV_SEQID, cov_mode=par.cov_mode,
                    cov_thr=par.cov_thr, eval_thr=par.evalue,
                    seq_id_mode=par.seq_id_mode)[0]
                if not check_criteria(r, False, par.evalue, par.min_seq_id,
                                      par.min_aln_len, par.cov_mode,
                                      par.cov_thr):
                    return False, []
                if include_aln:
                    staged.append(r)
            return True, staged

        for t_key, diag in zip(hit_keys, hit_diags):
            STATS["hits"] += 1
            tid = reader.get_id(t_key)
            if t_key == rep_key:
                members.append(i)
                if include_aln:
                    records.append(AlnResult(
                        db_key=rep_key, score=q_len, raw_score=q_len,
                        seq_id=1.0, eval=0.0, q_start=0, q_end=q_len - 1,
                        q_len=q_len, db_start=0, db_end=q_len - 1,
                        db_len=q_len, qcov=1.0, dbcov=1.0,
                        aln_length=q_len,
                        backtrace="M" * q_len if add_bt else ""))
                continue
            if tid in assigned:
                continue
            t_seq = np.frombuffer(reader.get_seq(tid), np.uint8)
            t_len = len(t_seq)
            if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                        float(q_len), float(t_len)):
                continue
            u = _ungapped(amat, q_seq, t_seq, diag, evaluer, q_len, t_len,
                          par.seq_id_mode)
            if u is None:
                continue
            if _passes(u, par):
                ok, staged = member_gate_ok(t_key, diag)
                if not ok:
                    continue
                if include_aln:
                    bits = int(evaluer.compute_bit_score(u["score"]) + 0.5)
                    records.append(_ungapped_result(t_key, u, q_len, t_len,
                                                    bits, add_bt))
                    records.extend(staged)
                members.append(tid)
                STATS["ungapped_accepted"] += 1
                continue
            spc = (u["score"] / u["diag_len"]) if u["diag_len"] else 0.0
            if spc < spc_thr or u["aln_len"] < 3:
                continue
            if not _has_seed(q_seq, t_seq, u):
                continue
            if ctx is None:
                ctx = aligner.init_query(q_num)
            STATS["gapped_calls"] += 1
            r = aligner.align_query(
                ctx, [t_key], [seqdb.seq_num(tid)], [t_len], [False],
                mode=SCORE_COV_SEQID, cov_mode=par.cov_mode,
                cov_thr=par.cov_thr, eval_thr=par.evalue,
                seq_id_mode=par.seq_id_mode)[0]
            if not check_criteria(r, False, par.evalue, par.min_seq_id,
                                  par.min_aln_len, par.cov_mode,
                                  par.cov_thr):
                continue
            ok, staged = member_gate_ok(t_key, diag)
            if not ok:
                continue
            if include_aln:
                records.append(r)
                records.extend(staged)
            members.append(tid)
            STATS["gapped_accepted"] += 1

        if i not in members:
            members.insert(0, i)
        for m in members:
            assigned[m] = rep_key
        clusters[rep_key] = [reader.get_db_key(m) for m in members]
        if include_aln:
            aln_out[rep_key] = records

    # singletons for anything never touched (no pref entry)
    for i in range(reader.size):
        if i not in assigned:
            key = reader.get_db_key(i)
            assigned[i] = key
            clusters[key] = [key]

    with DBWriter(out_path, dbt.DBTYPE_CLUSTER_RES,
                  compressed=bool(par.compressed)) as w:
        for rep_key in sorted(clusters):
            mem = clusters[rep_key]
            uniq = [rep_key] + [k for k in mem if k != rep_key]
            w.write(rep_key, ("\n".join(str(k) for k in uniq) + "\n")
                    .encode())
    if include_aln:
        with DBWriter(out_path + "_aln", dbt.DBTYPE_ALIGNMENT_RES,
                      compressed=bool(par.compressed)) as w:
            for rep_key in sorted(aln_out):
                w.write(rep_key, "".join(
                    r.to_line(add_bt) for r in aln_out[rep_key]).encode())
    res.close()
    reader.close()
    if clu_db is not None:
        clu_db.close()
        clu_seq.close()
    return 0
