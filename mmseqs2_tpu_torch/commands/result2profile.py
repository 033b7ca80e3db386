"""`result2profile` and `filterresult`: alignment results -> PSSM profile DB.

Port of mmseqs2_tpu/commands/result2profile.py. Reference: src/util/result2profile.cpp — per query: gather hits with
E < --e-profile, realign without stored backtraces (SCORE_COV_SEQID, no
thresholds), build the noDeletion center-star MSA, HH-style filter
(--filter-msa), PSSM with substitution pseudocounts, global composition bias
correction on the int8 scores, tantan profile masking, serialize 25 bytes
per position (DBTYPE_HMM_PROFILE). Key-only hits are aligned again through
Aligner.align_query (the `sw_multi` kernel on the card). `sequence2profile`
builds context-pseudocount profiles of single sequences (profile/cs.py).
"""

import numpy as np

from ..align.aligner import Aligner, SCORE_COV_SEQID
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..ops.tantan import likelihood_ratio_matrix, mask_batch
from ..profile import filter as msafilter
from ..profile import msa as msamod
from ..profile import pssm as pssmmod
from ..profile.io import parse_profile
from ..utils import log
from .common import EncodedDB, fast_atoi, get_sub_mat, open_seq_db
from .convertalis import expand_cigar
from .expandaln import Rec


class HitRecord:
    __slots__ = ("db_key", "q_start", "q_end", "db_start", "db_end",
                 "backtrace", "eval")


def parse_aln_line(parts):
    h = HitRecord()
    h.db_key = fast_atoi(parts[0])
    h.eval = float(parts[3]) if len(parts) > 3 else 0.0
    if len(parts) > 8:
        h.q_start = int(parts[4])
        h.q_end = int(parts[5])
        h.db_start = int(parts[7])
        h.db_end = int(parts[8])
    else:
        # key-only entry (cluster DB input): alignment recomputed on device
        h.q_start = h.q_end = h.db_start = h.db_end = -1
    h.backtrace = expand_cigar(parts[10].decode()) if len(parts) > 10 else ""
    return h


def gather_msa_input(par, aligner, ctx, qdb, tdb, treader, query_key, data,
                     same_db):
    """Hits + backtraces for one query's result entry."""
    hits = []
    need_aln = []
    for line in data.split(b"\n"):
        if not line:
            continue
        parts = line.split(b"\t")
        key = fast_atoi(parts[0])
        if key == query_key and same_db:
            continue
        evalue = float(parts[3]) if len(parts) >= 4 else 0.0
        # evalProfile = min(-e, --e-profile)  (result2profile.cpp:33)
        if evalue >= min(par.evalue, par.e_profile):
            continue
        h = parse_aln_line(parts)
        if not h.backtrace:
            need_aln.append(len(hits))
        hits.append(h)
    if need_aln:
        keys = [hits[i].db_key for i in need_aln]
        tids = [treader.get_id(k) for k in keys]
        tseqs = [tdb.seq_num(t) for t in tids]
        tlens = [tdb.seq_len(t) for t in tids]
        results = aligner.align_query(
            ctx, keys, tseqs, tlens, [False] * len(keys),
            SCORE_COV_SEQID, 0, 0.0, np.finfo(np.float64).max)
        for i, res in zip(need_aln, results):
            hits[i].q_start = res.q_start
            hits[i].q_end = res.q_end
            hits[i].db_start = res.db_start
            hits[i].db_end = res.db_end
            hits[i].backtrace = res.backtrace
    return hits


def result2profile(par, command):
    qdb_path, tdb_path, res_path, out_path = par.filenames[:4]
    same_db = qdb_path == tdb_path
    submat = get_sub_mat(par)
    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    res = DBReader(res_path)

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)

    qid = int(float(par.qid.split(",")[0]) * 100)
    # --profile-output-mode 1: plain text profile probabilities, flat file
    # (result2profile.cpp:106-110,266-271,293-296)
    write_plain = par.profile_output_mode == 1
    if write_plain:
        plain_out = open(out_path, "w")
        writer = None
    else:
        writer = DBWriter(out_path, dbt.DBTYPE_HMM_PROFILE)
    query_is_profile = qreader.base_type == dbt.DBTYPE_HMM_PROFILE
    for i in range(res.size):
        query_key = res.get_db_key(i)
        qid_local = qreader.get_id(query_key)
        if query_is_profile:
            # profile query (blastpgp iterations >= 2): the MSA center is the
            # profile's query letters (Sequence::mapProfile numSequence)
            prof_entry = parse_profile(qreader.get_data(qid_local))
            q_num = prof_entry.query_num.astype(np.int64)
            ctx = aligner.init_profile_query(prof_entry)
        else:
            q_num = qdb.seq_num(qid_local)
            ctx = aligner.init_query(q_num)
        hits = gather_msa_input(par, aligner, ctx, qdb, tdb, treader,
                                query_key, res.get_data(i), same_db)
        edge_seqs = [tdb.seq_num(treader.get_id(h.db_key)) for h in hits]
        msa = msamod.compute_msa_nodel(q_num, edge_seqs, hits)
        if par.filter_msa:
            kept, _ = msafilter.filter_msa(
                msa, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
                par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
                par.filter_min_enable)
            msa = msa[kept]
        out = pssmmod.compute_pssm_from_msa(msa, submat, par.wg)
        pssm = out["pssm"]
        if par.comp_bias_corr:
            pssm = global_bias_correct(pssm, submat)
        if par.mask_profile:
            pssm = mask_profile(pssm, q_num, submat)
        if write_plain:
            plain_out.write(f"Query profile of sequence {query_key}\n")
            plain_out.write(_profile_to_string(out["profile"], submat))
        else:
            payload = pssmmod.profile_to_buffer(
                pssm, q_num, out["consensus"], out["neff"], submat.aa2num)
            writer.write(query_key, payload)
    if write_plain:
        plain_out.close()
    else:
        writer.close()
    return 0


def _profile_to_string(profile: np.ndarray, submat) -> str:
    """PSSMCalculator::profileToString (PSSMCalculator.cpp:242-257)."""
    buf = [" " * 5]
    for aa in range(20):
        buf.append(submat.alphabet[aa])
        buf.append(" " * 6)
    buf.append("\n")
    for row in profile:
        for aa in range(20):
            buf.append(f"{row[aa]:.4f} ")
        buf.append("\n")
    buf.append("\n")
    return "".join(buf)


def global_bias_correct(pssm: np.ndarray, submat) -> np.ndarray:
    """SubstitutionMatrix::calcGlobalAaBiasCorrection on int8 scores.

    The reference accumulates the window sums sequentially in float32; the
    truncation to int is sensitive to that order, so we replicate it with a
    per-position f32 cumsum (cumsum is sequential)."""
    L = pssm.shape[0]
    p = pssm.astype(np.float32)
    pb = submat.pback[:20].astype(np.float32)
    # pNull[pos] += pBack[a] (double) * score (float): double products folded
    # into a float accumulator, per the reference's mixed precision
    pb64 = submat.pback[:20].astype(np.float64)
    pnull = np.zeros(L, dtype=np.float32)
    for a in range(20):
        pnull = (pnull.astype(np.float64)
                 + pb64[a] * p[:, a].astype(np.float64)).astype(np.float32)
    w = 40
    # the reference corrects profileScores IN PLACE, so windows of later
    # positions read already-corrected earlier rows; pNull stays original
    scores = p.copy()
    for i in range(L):
        lo = max(0, i - w // 2)
        hi = min(L, i + w // 2)
        rows = [j for j in range(lo, hi) if j != i]
        if rows:
            terms = (scores[rows] - pnull[rows, None]).astype(np.float32)
            aa_sum = np.cumsum(terms, axis=0, dtype=np.float32)[-1]
        else:
            aa_sum = np.zeros(20, dtype=np.float32)
        corrected = scores[i] - aa_sum / np.float32(hi - lo)
        scores[i] = np.trunc(corrected).astype(np.int8).astype(np.float32)
    return scores.astype(np.int8)


def mask_profile(pssm: np.ndarray, q_num: np.ndarray, submat) -> np.ndarray:
    """Masker::maskPssm: tantan over the query; masked rows set to -1."""
    lr = likelihood_ratio_matrix(submat)
    x_idx = submat.alphabet_size - 1
    masked, _ = mask_batch([q_num.copy()], lr, x_idx)
    out = pssm.copy()
    out[masked[0] == x_idx] = -1
    return out


def filterresult(par, command):
    """MSA-filter an alignment result DB and write back the surviving hits
    (reference src/util/result2profile.cpp:336-338 filterresult =
    result2profile(returnAlnRes=true): no E-value gate, the MsaFilter always
    runs, output = filtered hits as 11-column records)."""
    qdb_path, tdb_path, res_path, out_path = par.filenames[:4]
    same_db = qdb_path == tdb_path
    submat = get_sub_mat(par)
    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    res = DBReader(res_path)

    evaluer = EvalueComputation(treader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)
    qid = int(float(par.qid.split(",")[0]) * 100)
    query_is_profile = qreader.base_type == dbt.DBTYPE_HMM_PROFILE
    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed)) as writer:
        # LINEAR_ACCCESS iteration (result2profile.cpp:45): offset order
        for i in (int(x) for x in np.argsort(res.offsets, kind="stable")):
            query_key = res.get_db_key(i)
            qid_local = qreader.get_id(query_key)
            if qid_local < 0:
                log.warning(f"Invalid query sequence {query_key}")
                continue
            if query_is_profile:
                prof_entry = parse_profile(qreader.get_data(qid_local))
                q_num = prof_entry.query_num.astype(np.int64)
                ctx = aligner.init_profile_query(prof_entry)
            else:
                q_num = qdb.seq_num(qid_local)
                ctx = aligner.init_query(q_num)
            out_lines = []
            hits = []
            need_aln = []
            for line in res.get_data(i).split(b"\n"):
                if not line:
                    continue
                parts = line.split(b"\t")
                key = fast_atoi(parts[0])
                if key == query_key and same_db:
                    if par.include_identity:
                        out_lines.append(Rec.parse(parts).to_line(True))
                    continue
                if len(parts) > 10:
                    r = Rec.parse(parts)
                else:
                    # cluster-format / backtrace-less entry: recompute the
                    # alignment (result2profile.cpp:224-233)
                    r = Rec()
                    r.db_key = key
                    r.backtrace = ""
                if not r.backtrace:
                    need_aln.append(len(hits))
                hits.append(r)
            if need_aln:
                keys = [hits[k].db_key for k in need_aln]
                tids = [treader.get_id(k) for k in keys]
                results = aligner.align_query(
                    ctx, keys, [tdb.seq_num(t) for t in tids],
                    [tdb.seq_len(t) for t in tids], [False] * len(keys),
                    SCORE_COV_SEQID, 0, 0.0, np.finfo(np.float64).max)
                for k, r2 in zip(need_aln, results):
                    hits[k] = r2
            edge_seqs = [tdb.seq_num(treader.get_id(h.db_key)) for h in hits]
            msa = msamod.compute_msa_nodel(q_num, edge_seqs, hits)
            kept, _ = msafilter.filter_msa(
                msa, submat.sub_matrix, int(par.cov_msa_thr * 100), qid,
                par.qsc, int(par.filter_max_seq_id * 100), par.n_diff,
                par.filter_min_enable)
            for row in np.nonzero(kept)[0]:
                if row == 0:
                    continue
                out_lines.append(hits[row - 1].to_line(True))
            writer.write(query_key, "".join(out_lines).encode())
    res.close()
    return 0


def sequence2profile(par, command):
    """`sequence2profile` — single sequences to context-pseudocount profiles
    (reference src/util/sequence2profile.cpp). Each sequence gets the
    CSProfile context mix (profile/cs.py: one product per sequence, on the
    device for a library of 512 or more contexts),
    an 8-bit log-PSSM, optional tantan profile masking, and the 25-byte
    toBuffer layout. NOTE the reference quirk reproduced here: the
    consensus byte passes numeric residues through aa2num, mapping every
    position to X (sequence2profile.cpp:63 + SubstitutionMatrix.cpp:293).

    The reference embeds its K4000.crf context library via git-lfs which is
    absent from this source snapshot, so the default library here is the
    documented synthetic one (profile/cs.py); --context-lib loads a real
    .crf file."""
    from ..profile import cs as csmod

    in_path, out_path = par.filenames[:2]
    submat = get_sub_mat(par)
    reader = DBReader(in_path)
    if par.context_lib:
        lib = csmod.load_crf(open(par.context_lib).read())
    else:
        lib = csmod.synthetic_library(par.sub_mat.aa)
    ext = 0
    if par.pc_mode == 1:
        ext = dbt.DBTYPE_EXTENDED_CONTEXT_PSEUDO_COUNTS
    enc = submat.make_aa2num_table()
    with DBWriter(out_path, dbt.DBTYPE_HMM_PROFILE, ext,
                  compressed=bool(par.compressed)) as writer:
        for i in range(reader.size):
            key = reader.get_db_key(i)
            q_num = enc[np.frombuffer(reader.get_seq(i),
                                      np.uint8)].astype(np.int64)
            L = len(q_num)
            prof = csmod.compute_sequence_cs(q_num, lib, tau=par.tau)
            pssm = pssmmod.compute_log_pssm(prof, submat.pback, 8.0, 0.0)
            if par.mask_profile:
                pssm = mask_profile(pssm, q_num.copy(), submat)
            neff = np.ones(L, np.float32)
            out = np.zeros((L, 25), np.uint8)
            out[:, :20] = pssm.view(np.uint8)
            out[:, 20] = q_num.astype(np.uint8)
            out[:, 21] = 20    # aa2num[numeric byte] == X, see docstring
            out[:, 22] = pssmmod.convert_neff_to_char(neff)
            writer.write(key, out.tobytes())
    reader.close()
    return 0
