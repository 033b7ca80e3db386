"""`align` command: gapped alignment of prefilter results (protein path).

Port of mmseqs2_tpu/commands/align_cmd.py. Reference behavior:
src/alignment/Alignment.cpp (main loop :248-460, acceptance :389-397, mode
escalation :28-90) + Matcher::getSWResult. The SW score/endpoint passes run
on the device per query batch; the banded backtrace runs host-side for
accepted candidates only. Nucleotide and profile queries and `lcaalign` are
not yet ported (see ROADMAP.md).
"""

import numpy as np

from ..align import util as autil
from ..align.aligner import (Aligner, SCORE_COV, SCORE_COV_SEQID, SCORE_ONLY,
                             sort_results)
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..utils import log
from .common import EncodedDB, get_sub_mat, open_seq_db, parse_prefilter_entry

ALIGNMENT_MODE_FAST_AUTO = 0
ALIGNMENT_MODE_SCORE_ONLY = 1
ALIGNMENT_MODE_SCORE_COV = 2
ALIGNMENT_MODE_SCORE_COV_SEQID = 3
ALIGNMENT_MODE_UNGAPPED = 4


def init_sw_mode(alignment_mode: int, cov_thr: float, seq_id_thr: float) -> int:
    """Alignment::initSWMode (reference src/alignment/Alignment.cpp:167)."""
    if alignment_mode == ALIGNMENT_MODE_FAST_AUTO:
        if cov_thr > 0.0 and seq_id_thr == 0.0:
            return SCORE_COV
        if cov_thr > 0.0 and seq_id_thr > 0.0:
            return SCORE_COV_SEQID
        return SCORE_ONLY
    if alignment_mode == ALIGNMENT_MODE_SCORE_COV:
        return SCORE_COV
    if alignment_mode == ALIGNMENT_MODE_SCORE_COV_SEQID:
        return SCORE_COV_SEQID
    return SCORE_ONLY


def check_criteria(res, is_identity, eval_thr, seq_id_thr, aln_len_thr,
                   cov_mode, cov_thr) -> bool:
    """Alignment::checkCriteria (reference src/alignment/Alignment.cpp)."""
    if is_identity:
        return True
    return (res.eval <= eval_thr
            and res.seq_id >= seq_id_thr
            and autil.has_coverage(cov_thr, cov_mode, res.qcov, res.dbcov)
            and res.aln_length >= aln_len_thr)


def _alt_alignments(par, aligner, ctx, query_key, base_results, tdb, treader,
                    same_db, cov_thr, eval_thr, sw_mode, x_idx):
    """Alternative alignments: mask each accepted hit's aligned target region
    with X and realign up to --alt-ali times while the thresholds still pass
    (Alignment.cpp:569-601; end-exclusive mask quirk at :586-588,595-597).
    Returns the extra accepted results."""
    extra = []
    for r in base_results:
        is_identity = (r.db_key == query_key
                       and (par.include_identity or same_db))
        if is_identity:
            continue
        tid = treader.get_id(r.db_key)
        seq = np.array(tdb.seq_num(tid)).copy()
        seq[r.db_start:r.db_end] = x_idx
        for _ in range(par.alt_align):
            res = aligner.align_query(
                ctx, [r.db_key], [seq], [len(seq)], [False], sw_mode,
                par.cov_mode, cov_thr, eval_thr, par.seq_id_mode)[0]
            if not check_criteria(res, False, eval_thr, par.min_seq_id,
                                  par.min_aln_len, par.cov_mode, cov_thr):
                break
            extra.append(res)
            seq[res.db_start:res.db_end] = x_idx
    return extra


def align(par, command):
    qdb_path, tdb_path, pref_path, out_path = par.filenames[:4]
    same_db = qdb_path == tdb_path

    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    query_is_nucl = qreader.base_type == dbt.DBTYPE_NUCLEOTIDES
    if par.wrapped_scoring and not query_is_nucl:
        log.die("Wrapped scoring is only supported for nucleotides")
    if query_is_nucl:
        raise NotImplementedError(
            "nucleotide alignment is not yet ported (see ROADMAP.md)")
    if qreader.base_type == dbt.DBTYPE_HMM_PROFILE:
        raise NotImplementedError(
            "profile-query alignment is not yet ported (see ROADMAP.md)")
    submat = get_sub_mat(par, score_bias=par.score_bias)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    prefdb = DBReader(pref_path)

    # mode escalation + realign setup (Alignment.cpp:35-56,90)
    alignment_mode = par.alignment_mode
    add_backtrace = par.add_backtrace
    if add_backtrace:
        alignment_mode = ALIGNMENT_MODE_SCORE_COV_SEQID
    realign = par.realign
    cov_thr = par.cov_thr
    realign_sw_mode = None
    realign_cov = 0.0
    if realign:
        realign_sw_mode = init_sw_mode(
            max(alignment_mode, ALIGNMENT_MODE_SCORE_COV), 0.0, 0.0)
        alignment_mode = ALIGNMENT_MODE_SCORE_ONLY
        realign_cov = cov_thr
        cov_thr = 0.0
        if not add_backtrace:
            log.warning("Turn on backtrace for realign.")
            add_backtrace = True
    sw_mode = init_sw_mode(alignment_mode, par.cov_thr, par.min_seq_id)

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale,
                      par.corr_score_weight)
    realigner = aligner
    if realign and par.realign_score_bias != 0.0:
        realign_mat = get_sub_mat(
            par, score_bias=par.score_bias + par.realign_score_bias)
        realigner = Aligner(realign_mat, par.gap_open.aa, par.gap_extend.aa,
                            evaluer, par.comp_bias_corr,
                            par.comp_bias_corr_scale,
                            par.corr_score_weight)

    # --alignment-output-mode 1: key-only cluster format
    # (Alignment.cpp:250-252, 499-503)
    cluster_out = par.alignment_output_mode == 1
    writer = DBWriter(out_path, dbt.DBTYPE_CLUSTER_RES if cluster_out
                      else dbt.DBTYPE_ALIGNMENT_RES)
    total_passed = 0
    aln_num = 0
    BLOCK = 256     # queries per align_batch (one scan per shape group;
                    # bigger blocks fill the 16k-lane launches better)
    pid = 0
    while pid < prefdb.size:
        block = []
        while pid < prefdb.size and len(block) < BLOCK:
            query_key = prefdb.get_db_key(pid)
            data = prefdb.get_data(pid)
            pid += 1
            if not data:
                block.append((query_key, None))
                continue
            hit_keys, _, _ = parse_prefilter_entry(data)
            qid = qreader.get_id(query_key)
            ctx = aligner.init_query(qdb.seq_num(qid))
            q_len = qdb.seq_len(qid)

            # canBeCovered pre-gate (counts as a rejection in the replay)
            cand = []
            for key in hit_keys:
                tid = treader.get_id(key)
                if tid < 0:
                    log.die(f"Sequence {key} required by the prefilter "
                            f"result is missing from the target database")
                t_len = tdb.seq_len(tid)
                if not autil.can_be_covered(cov_thr, par.cov_mode,
                                            float(q_len), float(t_len)):
                    cand.append(None)
                else:
                    cand.append((key, tid, t_len))

            keys = [c[0] for c in cand if c]
            tids = [c[1] for c in cand if c]
            tlens = [c[2] for c in cand if c]
            ident = [same_db and k == query_key or
                     (par.include_identity and k == query_key)
                     for k in keys]
            tseqs = [tdb.seq_num(t) for t in tids]
            block.append((query_key, dict(
                qid=qid, ctx=ctx, cand=cand, keys=keys, tids=tids,
                tlens=tlens, ident=ident, tseqs=tseqs)))

        jobs = [(b["ctx"], b["keys"], b["tseqs"], b["tlens"], b["ident"])
                for _, b in block if b is not None]
        batch_results = aligner.align_batch(
            jobs, sw_mode, par.cov_mode, cov_thr, par.evalue,
            par.seq_id_mode)
        bi = 0
        for query_key, b in block:
            lines = []
            if b is None:
                writer.write(query_key, b"")
                continue
            ctx = b["ctx"]
            cand = b["cand"]
            ident = b["ident"]
            tids = b["tids"]
            qid = b["qid"]
            results = batch_results[bi]
            bi += 1
            aln_num += len(results)

            # replay the accept/reject loop in prefilter order
            accepted = []
            passed = 0
            rejected = 0
            ri = 0
            for c in cand:
                if passed >= par.max_accept or rejected >= par.max_rejected:
                    break
                if c is None:
                    rejected += 1
                    continue
                res = results[ri]
                is_identity = ident[ri]
                tid_of = tids[ri]
                ri += 1
                if is_identity:
                    res.qcov, res.dbcov, res.seq_id = 1.0, 1.0, 1.0
                if check_criteria(res, is_identity, par.evalue,
                                  par.min_seq_id, par.min_aln_len,
                                  par.cov_mode, cov_thr):
                    accepted.append((res, tid_of, is_identity))
                    passed += 1
                    total_passed += 1
                    rejected = 0
                else:
                    rejected += 1
            if par.alt_align > 0 and not realign and accepted:
                x_idx = submat.alphabet.index("X")
                extra = _alt_alignments(
                    par, aligner, ctx, query_key,
                    [a[0] for a in accepted], tdb, treader, same_db,
                    cov_thr, par.evalue, sw_mode, x_idx)
                accepted += [(r, treader.get_id(r.db_key), False)
                             for r in extra]
            if len(accepted) > 1:
                order = sort_results([a[0] for a in accepted])
                by_id = {id(a[0]): a for a in accepted}
                accepted = [by_id[id(r)] for r in order]
            final = [a[0] for a in accepted]

            if realign and accepted:
                # second pass: recompute boundaries with the biased matrix,
                # keep score/eval from the first pass
                # (Alignment.cpp:408-445)
                rctx = realigner.init_query(qdb.seq_num(qid))
                r_keys = [r.db_key for r, _, _ in accepted]
                r_tids = [t for _, t, _ in accepted]
                r_ident = [i for _, _, i in accepted]
                r_tseqs = [tdb.seq_num(t) for t in r_tids]
                r_tlens = [tdb.seq_len(t) for t in r_tids]
                rres = realigner.align_query(
                    rctx, r_keys, r_tseqs, r_tlens, r_ident,
                    realign_sw_mode, par.cov_mode, realign_cov,
                    float("inf"), par.seq_id_mode)
                final = []
                for k, (first, _, is_identity) in enumerate(accepted):
                    if len(final) >= par.realign_max_seqs:
                        break
                    res = rres[k]
                    cov_ok = autil.has_coverage(realign_cov, par.cov_mode,
                                                res.qcov, res.dbcov)
                    if cov_ok or is_identity:
                        res.score = first.score
                        res.raw_score = first.raw_score
                        res.eval = first.eval
                        final.append(res)
                if par.alt_align > 0 and final:
                    x_idx = submat.alphabet.index("X")
                    extra = _alt_alignments(
                        par, realigner, rctx, query_key, list(final), tdb,
                        treader, same_db, realign_cov, float("inf"),
                        realign_sw_mode, x_idx)
                    final += extra
                if len(final) > 1:
                    sort_results(final)
            if cluster_out:
                lines = [f"{r.db_key}\n" for r in final]
            else:
                lines = [r.to_line(add_backtrace) for r in final]
            writer.write(query_key, "".join(lines).encode())
    writer.close()
    log.info(f"{aln_num} alignments calculated, {total_passed} sequence pairs "
             f"passed the thresholds")
    return 0
