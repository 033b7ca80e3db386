"""`expandaln` / `expand2profile`: expand hits through intermediate cluster
alignments by backtrace composition.

Port of mmseqs2_tpu/commands/expandaln.py (host code: no kernel; `Rec` is
also the alignment record that `filterresult` parses and writes).
Reference: src/util/expandaln.cpp (main loop :86-440, rescoreResultByBacktrace
:27-77), src/commons/BacktraceTranslator.h (translateResult :50-153 with the
"Martins Clovis Eli" transition rules), src/commons/IntervalArray.h (a target
may cover a query region only once).

Given A->B alignments (with backtraces) and B->C alignments (cluster members
of each B), infers A->C alignments; `expand2profile` additionally turns the
expanded set into a query profile (MSA -> MsaFilter -> PSSM).
"""

import numpy as np

from ..align import util as autil
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.encode import calc_local_aa_bias
from ..ops.evalue import EvalueComputation
from ..utils import log
from .common import EncodedDB, get_sub_mat, open_seq_db
from .convertalis import expand_cigar

EXPAND_TRANSFER_EVALUE = 0
EXPAND_RESCORE_BACKTRACE = 1

# transitions[AB state][BC state] -> AC state ('' = consumed, no emit)
_TR = {
    ("M", "M"): "M", ("I", "M"): "I", ("D", "M"): "D",
    ("M", "D"): "D", ("I", "D"): "", ("D", "D"): "D",
    ("M", "I"): "I", ("I", "I"): "I", ("D", "I"): "",
}


class Rec:
    __slots__ = ("db_key", "score", "seq_id", "eval", "q_start", "q_end",
                 "q_len", "db_start", "db_end", "db_len", "backtrace",
                 "qcov", "dbcov", "aln_length", "raw_score")

    @classmethod
    def parse(cls, parts):
        r = cls()
        r.db_key = int(parts[0])
        r.score = int(parts[1])
        r.seq_id = float(parts[2])
        r.eval = float(parts[3])
        r.q_start = int(parts[4])
        r.q_end = int(parts[5])
        r.q_len = int(parts[6])
        r.db_start = int(parts[7])
        r.db_end = int(parts[8])
        r.db_len = int(parts[9])
        r.backtrace = expand_cigar(parts[10].decode()) \
            if len(parts) > 10 else ""
        r.aln_length = len(r.backtrace)
        r.qcov = autil.compute_cov(r.q_start, r.q_end, r.q_len)
        r.dbcov = autil.compute_cov(r.db_start, r.db_end, r.db_len)
        return r

    def to_line(self, add_backtrace=True):
        return autil.result_to_line(self, add_backtrace)


def parse_records(data: bytes):
    out = []
    for line in data.split(b"\n"):
        if line:
            out.append(Rec.parse(line.split(b"\t")))
    return out


def translate_result(ab: Rec, bc: Rec) -> Rec:
    """BacktraceTranslator::translateResult — compose A->B with B->C."""
    start_b_ab = ab.db_start
    start_b_bc = bc.q_start
    dist = abs(start_b_ab - start_b_bc)
    if start_b_ab < start_b_bc:
        a_off = b_off = bt_off = 0
        while b_off < dist and bt_off < len(ab.backtrace):
            s = ab.backtrace[bt_off]
            b_off += s in "MD"
            a_off += s in "MI"
            bt_off += 1
        off_ab, off_bc = bt_off, 0
        start_a = ab.q_start + a_off
        start_c = bc.db_start
    elif start_b_ab > start_b_bc:
        b_off = c_off = bt_off = 0
        while b_off < dist and bt_off < len(bc.backtrace):
            s = bc.backtrace[bt_off]
            b_off += s in "MI"
            c_off += s in "MD"
            bt_off += 1
        off_ab, off_bc = 0, bt_off
        start_a = ab.q_start
        start_c = bc.db_start + c_off
    else:
        off_ab = off_bc = 0
        start_a = ab.q_start
        start_c = bc.db_start

    bt = []
    last_m = 0
    q_aln = db_aln = 0
    i = 0
    while off_ab < len(ab.backtrace) and off_bc < len(bc.backtrace):
        i += 1
        t = _TR[(ab.backtrace[off_ab], bc.backtrace[off_bc])]
        if t == "":
            i -= 1
        else:
            if t == "M":
                last_m = i
                q_aln += 1
                db_aln += 1
            elif t == "D":
                q_aln += 1
            else:
                db_aln += 1
            bt.append(t)
        off_ab += 1
        off_bc += 1

    ac = Rec()
    ac.db_key = bc.db_key
    ac.score = bc.score
    ac.raw_score = bc.score
    ac.qcov = bc.qcov
    ac.dbcov = bc.dbcov
    ac.seq_id = bc.seq_id
    ac.eval = bc.eval
    ac.aln_length = bc.aln_length
    ac.q_start = start_a
    ac.q_end = start_a + q_aln - 1
    ac.q_len = ab.q_len
    ac.db_start = start_c
    ac.db_end = start_c + db_aln - 1
    ac.db_len = bc.db_len
    ac.backtrace = "".join(bt)[:last_m]
    return ac


def rescore_by_backtrace(res: Rec, q_num, t_num, submat, comp_bias,
                         gap_open, gap_extend, q_profile=None):
    """rescoreResultByBacktrace (expandaln.cpp:27-77): score + identities."""
    qpos, tpos = res.q_start, res.db_start
    score = 0
    identities = 0
    last = ""
    sm = submat.sub_matrix
    for state in res.backtrace:
        if state == "M":
            if q_profile is not None:
                score += int(q_profile[qpos, t_num[tpos]])
            else:
                b = comp_bias[qpos]
                score += int(sm[q_num[qpos], t_num[tpos]]) + int(
                    np.trunc(b - 0.5 if b < 0.0 else b + 0.5))
            identities += int(q_num[qpos] == t_num[tpos])
            qpos += 1
            tpos += 1
        elif state == "I":
            score -= gap_extend if last == "I" else gap_open
            qpos += 1
        else:
            score -= gap_extend if last == "D" else gap_open
            tpos += 1
        last = state
    res.score = score
    res.seq_id = identities
    return res


def _filter_bc(par, submat, creader, cdb, records):
    """--expand-filter-clusters (expandaln.cpp:276-315): diversity-filter
    each B cluster's member alignments against the cluster representative
    (first record with seqId==1 and qcov==1) before expansion; the first
    record is always kept."""
    from ..profile import filter as msafilter
    from ..profile import msa as msamod

    if not records:
        return records
    rep_num = None
    sub_set = []
    sub_records = []
    for r in records:
        if not r.backtrace:
            log.die("Alignment must contain a backtrace")
        if rep_num is None and r.seq_id == 1.0 and \
                autil.compute_cov(r.q_start, r.q_end, r.q_len) == 1.0:
            rep_num = cdb.seq_num(creader.get_id(r.db_key))
        else:
            sub_set.append(cdb.seq_num(creader.get_id(r.db_key)))
            sub_records.append(r)
    if rep_num is None:
        log.warning("Could not find representative sequence for filtering")
        return records
    head, rest = records[0], records[1:]
    msa = msamod.compute_msa_nodel(rep_num, sub_set, rest)
    qid = int(float(par.qid.split(",")[0]) * 100)
    kept_idx, _ = msafilter.filter_msa(
        msa, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
        par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
        par.filter_min_enable)
    kept = (kept_idx if getattr(kept_idx, "dtype", None) == bool
            else np.isin(np.arange(msa.shape[0]), kept_idx))
    out = [head]
    out.extend(r for row, r in enumerate(rest, start=1) if kept[row])
    return out


def _expand(par, command, return_aln: bool):
    a_path, c_path, res_ab_path, res_bc_path, out_path = par.filenames[:5]
    submat = get_sub_mat(par, score_bias=par.score_bias)
    areader = open_seq_db(a_path)
    creader = open_seq_db(c_path)
    adb = EncodedDB(areader, submat)
    cdb = EncodedDB(creader, submat)
    res_ab = DBReader(res_ab_path)
    res_bc = DBReader(res_bc_path)
    a_is_profile = areader.base_type == dbt.DBTYPE_HMM_PROFILE

    mode = par.expansion_mode
    evaluer = None
    if return_aln:
        evaluer = EvalueComputation(creader.total_residues(), submat,
                                    par.gap_open.aa, par.gap_extend.aa)
    eval_profile = min(par.evalue, par.e_profile)
    qid = int(float(par.qid.split(",")[0]) * 100)

    writer = DBWriter(out_path,
                      dbt.DBTYPE_ALIGNMENT_RES if return_aln
                      else dbt.DBTYPE_HMM_PROFILE)

    for i in range(res_ab.size):
        query_key = res_ab.get_db_key(i)
        a_id = areader.get_id(query_key)
        q_profile = None
        if a_is_profile:
            from ..profile.io import parse_profile
            p = parse_profile(areader.get_data(a_id))
            q_num = p.query_num.astype(np.int64)
            # profile_for_alignment scale scores (pssm/4 trunc)
            s = p.scores.astype(np.int64)
            q_profile = np.zeros((p.length, 21), np.int64)
            q_profile[:, :20] = np.sign(s) * (np.abs(s) // 4)
            comp_bias = np.zeros(p.length, np.float32)
        else:
            q_num = adb.seq_num(a_id)
            if mode == EXPAND_RESCORE_BACKTRACE and par.comp_bias_corr:
                comp_bias = calc_local_aa_bias(
                    q_num, submat.sub_matrix, submat.pback,
                    par.comp_bias_corr_scale)
            else:
                comp_bias = np.zeros(len(q_num), np.float32)

        intervals = {}
        results_ac = []
        seq_set = []
        for ab in parse_records(res_ab.get_data(i)):
            if not return_aln and ab.eval > eval_profile:
                continue
            if not ab.backtrace:
                log.die("Alignment must contain a backtrace")
            b_res_id = res_bc.get_id(ab.db_key)
            if b_res_id < 0:
                log.warning(f"Missing alignments for sequence {ab.db_key}")
                continue
            bc_records = parse_records(res_bc.get_data(b_res_id))
            if par.expand_filter_clusters:
                bc_records = _filter_bc(par, submat, creader, cdb,
                                        list(bc_records))
            for bc in bc_records:
                if not bc.backtrace:
                    log.die("Alignment must contain a backtrace")
                ac = translate_result(ab, bc)
                if not ac.backtrace:
                    continue
                if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                            ac.q_len, ac.db_len):
                    continue
                c_key = bc.db_key
                # reference quirk (expandaln.cpp:337-358): the whole
                # acceptance block sits in the map-miss branch, so a target
                # key contributes at most ONE accepted alignment per query;
                # rejected candidates do not block later ones
                if c_key in intervals:
                    continue
                c_id = creader.get_id(c_key)
                c_num = cdb.seq_num(c_id) if (
                    not return_aln or mode == EXPAND_RESCORE_BACKTRACE) \
                    else None
                if mode == EXPAND_RESCORE_BACKTRACE:
                    rescore_by_backtrace(ac, q_num, c_num, submat,
                                         comp_bias, par.gap_open.aa,
                                         par.gap_extend.aa, q_profile)
                    if ac.score < -6:
                        continue
                    ac.eval = evaluer.compute_evalue(ac.score, len(q_num)) \
                        if evaluer else ac.eval
                    ac.score = int(evaluer.compute_bit_score(ac.score)
                                   + 0.5) if evaluer else ac.score
                    ac.seq_id = autil.compute_seq_id(
                        par.seq_id_mode, ac.seq_id, len(q_num), len(c_num),
                        len(ac.backtrace))
                else:
                    ac.eval = ab.eval
                    ac.score = ab.score
                    ac.seq_id = ab.seq_id
                qcov = autil.compute_cov(ac.q_start, ac.q_end, ac.q_len)
                tcov = autil.compute_cov(ac.db_start, ac.db_end, ac.db_len)
                if not autil.has_coverage(par.cov_thr, par.cov_mode, qcov,
                                          tcov):
                    continue
                if ac.seq_id < par.min_seq_id - 1e-7:
                    continue
                if ac.eval > par.evalue:
                    continue
                if ac.aln_length < par.min_aln_len:
                    continue
                if not return_aln:
                    seq_set.append(cdb.seq_num(c_id))
                results_ac.append(ac)
                intervals.setdefault(c_key, []).append(
                    (ac.q_start, ac.q_end))

        if return_aln:
            writer.write(query_key,
                         "".join(r.to_line(True) for r in results_ac)
                         .encode())
        else:
            from ..profile import msa as msamod
            from ..profile import filter as msafilter
            from ..profile import pssm as pssmmod
            from .result2profile import mask_profile

            class H:
                pass

            hits = []
            for r in results_ac:
                h = H()
                h.db_key = r.db_key
                h.q_start, h.q_end = r.q_start, r.q_end
                h.db_start, h.db_end = r.db_start, r.db_end
                h.backtrace = r.backtrace
                hits.append(h)
            msa = msamod.compute_msa_nodel(q_num, seq_set, hits)
            if par.filter_msa:
                kept, _ = msafilter.filter_msa(
                    msa, submat.sub_matrix, int(par.cov_msa_thr * 100),
                    qid, par.qsc, int(par.filter_max_seq_id * 100),
                    par.n_diff, par.filter_min_enable)
                msa = msa[kept]
            out = pssmmod.compute_pssm_from_msa(msa, submat, par.wg)
            pssm = out["pssm"]
            # NOTE: unlike result2profile, expand2profile applies NO global
            # composition-bias correction (expandaln.cpp:419-424)
            if par.mask_profile:
                pssm = mask_profile(pssm, q_num, submat)
            payload = pssmmod.profile_to_buffer(
                pssm, q_num, out["consensus"], out["neff"], submat.aa2num)
            writer.write(query_key, payload)
    writer.close()
    return 0


def expandaln(par, command):
    return _expand(par, command, return_aln=True)


def expand2profile(par, command):
    # reference defaults filterMsa=1 for expand2profile (expandaln.cpp:89)
    if not par.was_set("filter_msa"):
        par.filter_msa = 1
    return _expand(par, command, return_aln=False)
