"""`align` command: gapped alignment of prefilter results (protein path).

Port of mmseqs2_tpu/commands/align_cmd.py. Reference behavior:
src/alignment/Alignment.cpp (main loop :248-460, acceptance :389-397, mode
escalation :28-90) + Matcher::getSWResult. The SW score/endpoint passes run
on the device per query batch; the banded backtrace runs host-side for
accepted candidates only; a profile query (DBTYPE_HMM_PROFILE) is aligned
with its PSSM columns (Aligner.init_profile_query). A nucleotide query is
aligned on the host by the banded ksw2 aligner (align/nucl_aligner.py), as
in the JAX package and the reference. `lcaalign` (the approximate 2bLCA of
the taxonomy search) runs its three passes as three waves of align_batch
per block of queries.
"""

import numpy as np

from ..align import util as autil
from ..align.aligner import (Aligner, SCORE_COV, SCORE_COV_SEQID, SCORE_ONLY,
                             sort_results)
from ..align.nucl_aligner import NuclAligner
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..profile.io import parse_profile
from ..utils import log
from .common import EncodedDB, get_sub_mat, open_seq_db, parse_prefilter_entry

ALIGNMENT_MODE_FAST_AUTO = 0
ALIGNMENT_MODE_SCORE_ONLY = 1
ALIGNMENT_MODE_SCORE_COV = 2
ALIGNMENT_MODE_SCORE_COV_SEQID = 3
ALIGNMENT_MODE_UNGAPPED = 4
INT_MAX = 2147483647
# queries per align_batch of `align` and per wave of `lcaalign` (one scan per
# shape group; bigger blocks fill the 16k-lane launches better)
BLOCK = 256
# lcaalign's pairs by wave (score-only pass, realign of the accepted hits,
# re-search against the top hit's target span): `pairs` aligned on the
# device path, `used` the pairs that the per-candidate loops reach before
# their breaks (the rest were computed and thrown away)
LCA_STATS = {}


def reset_lca_stats():
    LCA_STATS.clear()
    LCA_STATS.update(pairs=[0, 0, 0], used=[0, 0, 0])


reset_lca_stats()


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
        return _align_nucl(par, qreader, treader, same_db)
    submat = get_sub_mat(par, score_bias=par.score_bias)
    query_is_profile = qreader.base_type == dbt.DBTYPE_HMM_PROFILE
    qdb = None if query_is_profile else EncodedDB(qreader, submat)
    tdb = (qdb if same_db and not query_is_profile
           else EncodedDB(treader, submat))
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
        if query_is_profile:
            log.die("Cannot realign query profiles")
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
            if query_is_profile:
                prof_entry = parse_profile(qreader.get_data(qid))
                ctx = aligner.init_profile_query(prof_entry)
                q_len = prof_entry.length
            else:
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


def lcaalign(par, command):
    """Approximate 2bLCA alignment (Alignment.cpp lcaAlign branch): find the
    top hit, realign all prefilter candidates against the top hit's aligned
    target subsequence, and keep those under the top hit's E-value.

    The JAX package aligns the second and third passes one candidate at a
    time and stops at each loop's break. Here each block of BLOCK queries
    runs three waves of Aligner.align_batch: (1) every candidate, score
    mode; (2) each query's accepted hits in realign mode; (3) every
    candidate against its query's top-hit target span. After each wave the
    accept/reject loops walk the computed results on the host in the same
    order. A pair's alignment does not depend on the loop, so the bytes
    are the same; the pairs past a loop's break are computed and dropped
    (LCA_STATS counts both)."""
    qdb_path, tdb_path, pref_path, out_path = par.filenames[:4]
    same_db = qdb_path == tdb_path

    submat = get_sub_mat(par, score_bias=par.score_bias)
    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    prefdb = DBReader(pref_path)

    # lcaAlign setup (Alignment.cpp:39-56): first pass score-only, realign
    # top-1 with bias 0, then the lca re-search at the top hit's E-value
    alignment_mode = par.alignment_mode
    lca_sw_mode = init_sw_mode(max(alignment_mode, 1), 0.0, 0.0)
    realign_sw_mode = init_sw_mode(max(alignment_mode, 2), 0.0, 0.0)
    realign_cov = par.cov_thr
    sw_mode = init_sw_mode(max(alignment_mode, 1), par.cov_thr,
                           par.min_seq_id)

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)

    writer = DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES)
    pid = 0
    while pid < prefdb.size:
        block = []
        while pid < prefdb.size and len(block) < BLOCK:
            query_key = prefdb.get_db_key(pid)
            data = prefdb.get_data(pid)
            pid += 1
            q = dict(key=query_key, final=[])
            block.append(q)
            if not data:
                continue
            hit_keys, _, _ = parse_prefilter_entry(data)
            qid = qreader.get_id(query_key)
            q["ctx"] = aligner.init_query(qdb.seq_num(qid))
            tids = []
            for key in hit_keys:
                tid = treader.get_id(key)
                if tid < 0:
                    log.die(f"Sequence {key} required by the prefilter "
                            f"result is missing from the target database")
                tids.append(tid)
            q["keys"] = list(hit_keys)
            q["tseqs"] = [tdb.seq_num(t) for t in tids]
            q["tlens"] = [tdb.seq_len(t) for t in tids]
            q["ident"] = [(same_db and key == query_key)
                          or (par.include_identity and key == query_key)
                          for key in hit_keys]
        active = [q for q in block if "ctx" in q]

        # wave 1: every candidate, score mode; accept/reject in order
        wave = aligner.align_batch(
            [(q["ctx"], q["keys"], q["tseqs"], q["tlens"], q["ident"])
             for q in active], sw_mode, par.cov_mode, 0.0, par.evalue,
            par.seq_id_mode)
        for q, results in zip(active, wave):
            LCA_STATS["pairs"][0] += len(results)
            LCA_STATS["used"][0] += len(results)
            accepted = []
            passed = rejected = 0
            for k, (res, is_identity) in enumerate(zip(results, q["ident"])):
                if passed >= par.max_accept or rejected >= par.max_rejected:
                    break
                if is_identity:
                    res.qcov, res.dbcov, res.seq_id = 1.0, 1.0, 1.0
                if check_criteria(res, is_identity, par.evalue,
                                  par.min_seq_id, par.min_aln_len,
                                  par.cov_mode, 0.0):
                    accepted.append((res, k))
                    passed += 1
                    rejected = 0
                else:
                    rejected += 1
            if len(accepted) > 1:
                by_id = {id(a[0]): a for a in accepted}
                accepted = [by_id[id(r)] for r in
                            sort_results([a[0] for a in accepted])]
            q["accepted"] = accepted

        # wave 2: realign every accepted hit (bias 0 -> same matrix); the
        # top hit is the first whose coverage passes
        realigned = [q for q in active if q["accepted"]]
        wave = aligner.align_batch(
            [(q["ctx"], [r.db_key for r, _ in q["accepted"]],
              [q["tseqs"][k] for _, k in q["accepted"]],
              [q["tlens"][k] for _, k in q["accepted"]],
              [q["ident"][k] for _, k in q["accepted"]])
             for q in realigned], realign_sw_mode, par.cov_mode,
            realign_cov, float("inf"), par.seq_id_mode)
        for q, results in zip(realigned, wave):
            LCA_STATS["pairs"][1] += len(results)
            q["top1"] = None
            for (first, k), rres in zip(q["accepted"], results):
                LCA_STATS["used"][1] += 1
                cov_ok = autil.has_coverage(realign_cov, par.cov_mode,
                                            rres.qcov, rres.dbcov)
                if cov_ok or q["ident"][k]:
                    rres.score = first.score
                    rres.eval = first.eval
                    q["top1"] = (rres, k)
                    break

        # wave 3: the top hit's aligned target span becomes the query of
        # the lca pass over every candidate, at the top hit's E-value
        lca = [q for q in realigned if q["top1"] is not None]
        jobs, evals = [], []
        for q in lca:
            top1, k = q["top1"]
            sub_q = q["tseqs"][k][top1.db_start: top1.db_end + 1]
            jobs.append((aligner.init_query(sub_q), q["keys"], q["tseqs"],
                         q["tlens"], [False] * len(q["keys"])))
            evals.append(top1.eval)
        wave = aligner.align_batch(jobs, lca_sw_mode, par.cov_mode,
                                   realign_cov, evals, par.seq_id_mode)
        for q, top_eval, results in zip(lca, evals, wave):
            LCA_STATS["pairs"][2] += len(results)
            final = []
            rejected = 0
            for res in results:
                if rejected >= par.max_rejected:
                    break
                LCA_STATS["used"][2] += 1
                if check_criteria(res, False, top_eval, par.min_seq_id,
                                  par.min_aln_len, par.cov_mode,
                                  realign_cov):
                    final.append(res)
                    rejected = 0
                else:
                    rejected += 1
            if len(final) > 1:
                sort_results(final)
            q["final"] = final
        for q in block:
            writer.write(q["key"], "".join(
                r.to_line(par.add_backtrace) for r in q["final"]).encode())
    writer.close()
    return 0


def _align_nucl(par, qreader, treader, same_db):
    """Nucleotide gapped alignment: ungapped diagonal seed + ksw2 Z-drop
    extension per prefilter hit (Matcher::getSWResult nucleotide branch;
    alignment mode is always SCORE_COV_SEQID)."""
    qdb_path, tdb_path, pref_path, out_path = par.filenames[:4]
    submat = get_sub_mat(par, nucl=True, bit_factor=1.0,
                         score_bias=par.score_bias)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    prefdb = DBReader(pref_path)
    is_rev_pref = prefdb.base_type == dbt.DBTYPE_PREFILTER_REV_RES
    wrapped = bool(par.wrapped_scoring)
    if wrapped and par.realign:
        log.die("Alternative alignments do not support wrapped scoring")

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.nucl, par.gap_extend.nucl)
    aligner = NuclAligner(submat, par.gap_open.nucl, par.gap_extend.nucl,
                          par.zdrop, evaluer)

    writer = DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES)
    total_passed = 0
    aln_num = 0
    for pid in range(prefdb.size):
        query_key = prefdb.get_db_key(pid)
        data = prefdb.get_data(pid)
        lines = []
        if data:
            hit_keys, hit_scores, hit_diags = parse_prefilter_entry(data)
            qid = qreader.get_id(query_key)
            q_num = qdb.seq_num(qid)
            q_len = qdb.seq_len(qid)
            if wrapped:
                # double the query for circular end-start scoring
                # (Alignment.cpp:332-338)
                aligner.init_query(np.concatenate([q_num, q_num]))
            else:
                aligner.init_query(q_num)

            # batch the ksw2 extensions across the query's candidates when
            # there is no early-exit contract to honor (the defaults; the
            # reused-buffer staleness depends on the executed sequence, so
            # with --max-accept/--max-rejected the per-pair path is kept)
            batch_ok = (par.max_accept >= INT_MAX
                        and par.max_rejected >= INT_MAX)
            pre = []
            for key, score_in, diag in zip(hit_keys, hit_scores,
                                           hit_diags):
                tid = treader.get_id(key)
                if tid < 0:
                    log.die(f"Sequence {key} required by the prefilter "
                            f"result is missing from the target database")
                pre.append((key, score_in, diag, tid, tdb.seq_len(tid)))
            batch_res = None
            if batch_ok:
                cand = [p for p in pre
                        if autil.can_be_covered(par.cov_thr, par.cov_mode,
                                                float(q_len),
                                                float(p[4]))]
                rlist = aligner.align_pairs(
                    [tdb.seq_num(p[3]) for p in cand],
                    [p[2] for p in cand],
                    [is_rev_pref and p[1] < 0 for p in cand],
                    wrapped=wrapped)
                batch_res = {p[0]: r for p, r in zip(cand, rlist)}

            accepted = []
            passed = 0
            rejected = 0
            for key, score_in, diag, tid, t_len in pre:
                if passed >= par.max_accept or rejected >= par.max_rejected:
                    break
                if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                            float(q_len), float(t_len)):
                    rejected += 1
                    continue
                # a hit is reversed iff its prefilter score is negative
                # in a PREFILTER_REV_RES DB (rescorediagonal.cpp:200-205)
                if batch_res is not None:
                    res = batch_res[key]
                else:
                    res = aligner.align(tdb.seq_num(tid), diag,
                                        is_rev_pref and score_in < 0,
                                        wrapped=wrapped)
                res.db_key = key
                aln_num += 1
                res.seq_id = float(autil.compute_seq_id(
                    par.seq_id_mode, res.aa_ids, q_len, t_len,
                    len(res.backtrace) if res.backtrace
                    else res.aln_length))
                is_identity = (same_db and key == query_key) or \
                    (par.include_identity and key == query_key)
                if is_identity:
                    res.qcov, res.dbcov, res.seq_id = 1.0, 1.0, 1.0
                if check_criteria(res, is_identity, par.evalue,
                                  par.min_seq_id, par.min_aln_len,
                                  par.cov_mode, par.cov_thr):
                    accepted.append(res)
                    passed += 1
                    total_passed += 1
                    rejected = 0
                else:
                    rejected += 1
            if len(accepted) > 1:
                sort_results(accepted)
            lines = [r.to_line(par.add_backtrace) for r in accepted]
        writer.write(query_key, "".join(lines).encode())
    writer.close()
    log.info(f"{aln_num} alignments calculated, {total_passed} sequence "
             f"pairs passed the thresholds")
    return 0
