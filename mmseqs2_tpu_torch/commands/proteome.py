"""Proteome clustering subsystem.

Reference sources:
  - src/util/proteomecluster.cpp — greedy reference-proteome selection +
    per-cluster protein alignment and proteome similarity scoring;
  - src/util/parseproteomealignments.cpp — proteome-vs-proteome match
    fractions from a protein search result;
  - src/util/pickrepprofile.cpp — profile-consensus representative pick
    from stored cluster alignments;
  - data/workflow/pickconsensusrep.sh / pickconsensusrepfast.sh /
    easyproteomecluster.sh / easyproteomesearch.sh — the workflows.

Port of mmseqs2_tpu/commands/proteome.py. proteomecluster aligns the
clusters of a round a block of BLOCK clusters in one Aligner.align_batch
(the `sw_multi` kernel on the card), where the JAX package calls
align_query once a cluster: within a round the reference proteome is
fixed, so a cluster's query, its targets and its coverage filter do not
depend on another cluster's result, and a pair's alignment does not depend
on its batch. The round then walks the results in cluster order, so the
records and counts are the same bytes. The rest is host code.
"""

import os
import time

import numpy as np

from ..align import aligner as aligner_mod
from ..align import util as autil
from ..align.aligner import Aligner, SCORE_COV_SEQID
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..ops import sw
from ..ops.evalue import EvalueComputation
from ..profile import msa as msamod
from ..profile import pssm as pssmmod
from ..utils import log
from ..workflow import Workflow
from .align_cmd import check_criteria
from .common import EncodedDB, fast_atoi, get_sub_mat, open_seq_db

# clusters of a proteomecluster round whose pairs go through one
# align_batch
BLOCK = 1024

# proteomecluster: rounds (reference proteomes picked), clusters aligned
# (those with a member of the round's reference, summed over the rounds),
# the (query, member) pairs aligned, the align_batch calls, the sw_multi
# launches and the aligner's read-backs they made, the kernels' device
# milliseconds (CUDA events; 0 on the CPU), the seconds of the alignment
# and of the rest of the rounds (cluster walk, query setup, records)
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(rounds=0, clusters=0, pairs=0, batches=0, launches=0,
                 readbacks=0, kernel_ms=0.0, align_s=0.0, host_s=0.0)


reset_stats()


def _read_source(db_path):
    """source id -> file name."""
    out = {}
    path = db_path + ".source"
    if os.path.exists(path):
        for line in open(path):
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[int(parts[0])] = parts[1]
    return out


def _key_to_source(reader):
    """db key -> source file number (via .lookup)."""
    lut = reader.read_lookup()
    return {k: v[1] for k, v in lut.items()}


def _fastfloat_pct(value):
    """fastfloatToBuffer: value*100 -> 'II.FF%' (proteomecluster.cpp:138)."""
    value *= 100.0
    ip = int(value)
    fp = int((value - ip) * 100)
    return f"{ip}.{fp:02d}%"


def parseproteomealignments(par, command):
    qdb_path, tdb_path, aln_path, out_path = par.filenames[:4]
    q = DBReader(qdb_path)
    t = q if tdb_path == qdb_path else DBReader(tdb_path)
    q_src = _key_to_source(q)
    t_src = _key_to_source(t)
    n_qsrc = len(_read_source(qdb_path)) or (max(q_src.values()) + 1
                                             if q_src else 0)
    n_tsrc = len(_read_source(tdb_path)) or (max(t_src.values()) + 1
                                             if t_src else 0)
    q_entries = np.zeros(n_qsrc, np.int64)
    for k in q.keys:
        q_entries[q_src[int(k)]] += 1
    scores = np.zeros((n_qsrc, n_tsrc), np.int64)
    aln = DBReader(aln_path)
    for i in range(aln.size):
        qsrc = q_src[int(aln.get_db_key(i))]
        seen = set()
        for line in aln.get_data(i).split(b"\n"):
            if not line.strip():
                continue
            seen.add(t_src[fast_atoi(line.split(b"\t")[0])])
        for s in seen:
            scores[qsrc, s] += 1
    aln.close()
    ext = dbt.DBTYPE_EXTENDED_SET
    with DBWriter(out_path, dbt.DBTYPE_GENERIC_DB, ext,
                  compressed=bool(par.compressed)) as w:
        for qs in range(n_qsrc):
            lines = []
            for ts in range(n_tsrc):
                frac = (scores[qs, ts] / q_entries[qs]
                        if q_entries[qs] else 0.0)
                lines.append(f"{ts}\t{autil.fast_seq_id_str(frac)}\n")
            w.write(qs, "".join(lines).encode())
    q.close()
    if t is not q:
        t.close()
    return 0


def _align_block(aligner, ctxs, block, par):
    """Every (query, member) pair of a block of clusters in one
    Aligner.align_batch, with the thresholds of the JAX package's
    align_query of each cluster; the AlnResult lists, a cluster each (empty
    where no member can be covered)."""
    jobs, owners = [], []
    for j, ((_, _, targets), ctx) in enumerate(zip(block, ctxs)):
        if targets:
            jobs.append((ctx, [t[0] for t in targets],
                         [t[1] for t in targets], [t[2] for t in targets],
                         [False] * len(targets)))
            owners.append(j)
    out = [[] for _ in block]
    if not jobs:
        return out
    st = aligner_mod.STATS
    before = (sw.sw_multi.launches, st["readbacks"], st["kernel_ms"])
    t0 = time.perf_counter()
    results = aligner.align_batch(
        jobs, mode=SCORE_COV_SEQID, cov_mode=par.cov_mode,
        cov_thr=par.cov_thr, eval_thr=par.evalue,
        seq_id_mode=par.seq_id_mode)
    STATS["align_s"] += time.perf_counter() - t0
    STATS["batches"] += 1
    STATS["pairs"] += sum(len(j[1]) for j in jobs)
    STATS["launches"] += sw.sw_multi.launches - before[0]
    STATS["readbacks"] += st["readbacks"] - before[1]
    STATS["kernel_ms"] += st["kernel_ms"] - before[2]
    for j, res in zip(owners, results):
        out[j] = res
    return out


def proteomecluster(par, command):
    seq_path, clu_path, out_aln, out_count, out_protein = par.filenames[:5]
    submat = get_sub_mat(par, score_bias=par.score_bias)
    reader = open_seq_db(seq_path)
    seqdb = EncodedDB(reader, submat)
    key_src = _key_to_source(reader)
    sources = _read_source(seq_path)
    clu = DBReader(clu_path)

    include_aln = bool(par.include_align_files
                       or par.proteome_include_align_files)
    if par.add_backtrace:
        par.set("alignment_mode", 3)
    evaluer = EvalueComputation(reader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)

    # proteome list: key -> [entry size, cluster count, shared, covered,
    #                         weight]
    entry_size = {}
    for k in reader.keys:
        s = key_src[int(k)]
        entry_size[s] = entry_size.get(s, 0) + 1
    proteomes = sorted(entry_size)
    weight = {p: 0.0 for p in proteomes}
    weight_file = par.pps_weight_file or par.proteome_weight_file
    if weight_file:
        name_to_src = {v: k for k, v in sources.items()}
        for line in open(weight_file):
            parts = line.split()
            if len(parts) >= 2 and parts[0] in name_to_src:
                weight[name_to_src[parts[0]]] = float(parts[1])

    # clusters with members from >1 proteome, members sorted by
    # (proteomeKey, proteinId)
    clusters = []
    cluster_count = {p: 0 for p in proteomes}
    total_clusters = 0
    for i in range(clu.size):
        members = []
        pset = set()
        for line in clu.get_data(i).split(b"\n"):
            if not line.strip():
                continue
            key = int(line.split()[0])
            src = key_src[key]
            members.append((src, reader.get_id(key)))
            pset.add(src)
        if len(pset) <= 1:
            continue
        members.sort()
        clusters.append(members)
        total_clusters += 1
        for p in pset:
            cluster_count[p] += 1

    ext = dbt.DBTYPE_EXTENDED_SET
    count_writer = DBWriter(out_count, dbt.DBTYPE_GENERIC_DB, ext,
                            compressed=bool(par.compressed))
    for p in proteomes:
        ratio = (cluster_count[p] / total_clusters) if total_clusters \
            else 0.0
        count_writer.write(
            p, f"{cluster_count[p]}\t{_fastfloat_pct(ratio)}\n".encode())
    count_writer.close()

    protein_records = {}   # rep protein key -> list of record strings
    covered = {}           # proteome -> (refKey, uni, bi)
    available = list(proteomes)
    shared = {p: 0 for p in proteomes}
    aln_entries = []       # (refProteomeKey, [(key, uni, bi) lines])
    add_bt = bool(par.add_backtrace)

    while available:
        if weight_file:
            wcc = (par.weight_cluster_count
                   or par.proteome_weight_cluster_count)
            ref = max(available,
                      key=lambda p: (weight[p]
                                     + (cluster_count[p] / total_clusters
                                        if total_clusters else 0) * wcc,
                                     ))
        else:
            available.sort(key=lambda p: (-cluster_count[p],
                                          entry_size[p], p))
            ref = available[0]
        log.info(f"Reference Proteome. Key: {ref}, Name: "
                 f"{sources.get(ref, '')}")
        ref_size = entry_size[ref]
        for p in proteomes:
            shared[p] = 0
        t0 = time.perf_counter()
        work = []
        for members in clusters:
            ref_members = [(s, pid) for s, pid in members if s == ref]
            if not ref_members:
                continue
            # longest reference protein is the cluster query
            qid = max(ref_members,
                      key=lambda m: reader.get_seq_len(m[1]))[1]
            q_num = seqdb.seq_num(qid)
            targets = []
            for s, pid in members:
                if s == ref:
                    continue
                t_len = reader.get_seq_len(pid)
                if autil.can_be_covered(par.cov_thr, par.cov_mode,
                                        float(len(q_num)), float(t_len)):
                    targets.append((int(reader.get_db_key(pid)),
                                    seqdb.seq_num(pid), t_len, s))
            work.append((int(reader.get_db_key(qid)), q_num, targets))
        STATS["rounds"] += 1
        STATS["clusters"] += len(work)
        for b0 in range(0, len(work), BLOCK):
            block = work[b0:b0 + BLOCK]
            ctxs = [aligner.init_query(q_num) for _, q_num, _ in block]
            STATS["host_s"] += time.perf_counter() - t0
            results = _align_block(aligner, ctxs, block, par)
            t0 = time.perf_counter()
            for (q_key, q_num, targets), ctx, res in zip(block, ctxs,
                                                         results):
                self_res = aligner.score_identical(ctx, q_num,
                                                   SCORE_COV_SEQID)
                self_res.db_key = q_key
                recs = [self_res.to_line(add_bt)]
                shared[ref] += 1
                for r, (_, _, _, src) in zip(res, targets):
                    if check_criteria(r, False, par.evalue,
                                      par.min_seq_id, par.min_aln_len,
                                      par.cov_mode, par.cov_thr):
                        recs.append(r.to_line(add_bt))
                        shared[src] += 1
                if include_aln:
                    protein_records[q_key] = recs
        STATS["host_s"] += time.perf_counter() - t0

        lines = [(ref, 1.0, 1.0)]
        covered[ref] = (ref, 1.0, 1.0)
        next_avail = []
        for p in available:
            if p == ref:
                continue
            uni = shared[p] / entry_size[p]
            bi = shared[p] * 2 / (ref_size + entry_size[p])
            if uni >= par.proteome_sim_thr \
                    and bi >= par.proteome_relative_sim_thr:
                covered[p] = (ref, uni, bi)
                lines.append((p, uni, bi))
            else:
                next_avail.append(p)
        aln_entries.append((ref, lines))
        available = next_avail
        if len(available) == 1:
            solo = available[0]
            covered[solo] = (solo, 1.0, 1.0)
            aln_entries.append((solo, [(solo, 1.0, 1.0)]))
            break
        if par.proteome_cascaded_clustering:
            break
        # recount clusters over uncovered proteomes
        total_clusters = 0
        for p in proteomes:
            cluster_count[p] = 0
        live = []
        for members in clusters:
            pset = {s for s, _ in members if s not in covered}
            if len(pset) <= 1:
                continue
            live.append(members)
            total_clusters += 1
            for p in pset:
                cluster_count[p] += 1
        clusters = live

    ext = dbt.DBTYPE_EXTENDED_SET
    with DBWriter(out_aln, dbt.DBTYPE_GENERIC_DB, ext,
                  compressed=bool(par.compressed)) as w:
        for ref, lines in aln_entries:
            body = "".join(
                f"{p}\t{autil.fast_seq_id_str(u)}\t"
                f"{autil.fast_seq_id_str(b)}\n" for p, u, b in lines)
            w.write(ref, body.encode())
    with DBWriter(out_protein, dbt.DBTYPE_GENERIC_DB,
                  compressed=bool(par.compressed)) as w:
        for key in sorted(protein_records):
            w.write(key, "".join(protein_records[key]).encode())
    clu.close()
    reader.close()
    return 0


def pickrepprofile(par, command):
    """Score observed cluster members against the cluster's profile PSSM
    and pick the best representative (pickrepprofile.cpp)."""
    seq_path, res_path, out_path = par.filenames[:3]
    submat = get_sub_mat(par, score_bias=-0.2)
    reader = open_seq_db(seq_path)
    if reader.base_type == dbt.DBTYPE_HMM_PROFILE:
        log.die("The sequence database must not be a profile database")
    seqdb = EncodedDB(reader, submat)
    res = DBReader(res_path)
    evaluer = EvalueComputation(reader.total_residues(), submat,
                                par.gap_open.aa, par.gap_extend.aa)
    aligner = Aligner(submat, par.gap_open.aa, par.gap_extend.aa, evaluer,
                      par.comp_bias_corr, par.comp_bias_corr_scale)
    from .result2profile import parse_aln_line

    missing_bt = False
    with DBWriter(out_path, dbt.DBTYPE_GENERIC_DB,
                  compressed=bool(par.compressed)) as writer:
        for i in range(res.size):
            q_key = res.get_db_key(i)
            qid = reader.get_id(q_key)
            if qid < 0:
                log.warning(f"Invalid representative sequence {q_key}")
                continue
            q_num = seqdb.seq_num(qid)
            ctx = None
            edge_seqs = []
            hits = []
            orig_scores = []
            for line in res.get_data(i).split(b"\n"):
                if not line.strip():
                    continue
                parts = line.split(b"\t")
                key = fast_atoi(parts[0])
                if key == q_key:
                    continue
                eid = reader.get_id(key)
                if eid < 0:
                    log.die(f"Sequence {key} does not exist in the "
                            f"sequence database")
                e_num = seqdb.seq_num(eid)
                h = parse_aln_line(parts)
                if not h.backtrace:
                    missing_bt = True
                    if ctx is None:
                        ctx = aligner.init_query(q_num)
                    r = aligner.align_query(
                        ctx, [key], [e_num], [len(e_num)], [False],
                        mode=SCORE_COV_SEQID, cov_mode=0, cov_thr=0.0,
                        eval_thr=np.finfo(np.float64).max)[0]
                    h.q_start, h.q_end = r.q_start, r.q_end
                    h.db_start, h.db_end = r.db_start, r.db_end
                    h.backtrace = r.backtrace
                    orig_scores.append(r.score)
                else:
                    orig_scores.append(fast_atoi(parts[1])
                                       if len(parts) > 1 else 0)
                edge_seqs.append(e_num)
                hits.append(h)
            if not edge_seqs:
                writer.write(q_key, f"{q_key}\t0\t1.0000\t1\n".encode())
                continue
            msa = msamod.compute_msa_nodel(q_num, edge_seqs, hits)
            prof = pssmmod.compute_pssm_from_msa(msa, submat, par.wg)
            pssm = prof["pssm"]                   # (L, 20) int8
            L = pssm.shape[0]
            best = None
            any_passed = False
            rep_stats = None
            for row in range(msa.shape[0]):
                states = msa[row][:L]
                mask = states < 20
                aligned = int(mask.sum())
                score = int(pssm[np.arange(L)[mask],
                                 states[mask]].astype(np.int64).sum()) \
                    if aligned else 0
                cov = aligned / L if L else 0.0
                cand_key = q_key if row == 0 else hits[row - 1].db_key
                orig = (1 << 31) - 1 if row == 0 else orig_scores[row - 1]
                if row == 0:
                    rep_stats = (cand_key, score, cov)
                if cov < par.cov_thr:
                    continue
                cand = (score, cov, orig, row == 0, -cand_key)
                if not any_passed or cand > best[0]:
                    best = (cand, cand_key, score, cov)
                    any_passed = True
            if not any_passed:
                bk, bs, bc = rep_stats
            else:
                _, bk, bs, bc = best
            writer.write(q_key,
                         f"{bk}\t{bs}\t{bc:.4f}\t{msa.shape[0]}\n"
                         .encode())
    if missing_bt:
        log.warning("Some alignment records had no backtrace and were "
                    "recomputed on the fly. Re-run the alignment with "
                    "'-a' to store backtraces if this was unintended.")
    res.close()
    reader.close()
    return 0


def _rewrite_clustering(rep_map, clu_path, out_path, par):
    """The awk rewrite shared by both pickconsensusrep workflows:
    per old cluster, emit newRep then members != newRep."""
    clu = DBReader(clu_path)
    with DBWriter(out_path, dbt.DBTYPE_CLUSTER_RES,
                  compressed=bool(par.compressed)) as w:
        for i in range(clu.size):
            old = clu.get_db_key(i)
            new = rep_map.get(old, old)
            lines = [str(new)]
            for tok in clu.get_data(i).split():
                k = int(tok)
                if k != new:
                    lines.append(str(k))
            w.write(new, ("\n".join(lines) + "\n").encode())
    clu.close()


def pickconsensusrep(par, command):
    """pickconsensusrep.sh: cluster MSA -> profile -> align members to the
    profile -> best-scoring member becomes the representative."""
    seq_db, clu_db, out_db, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)
    msa = wf.path("msa")
    wf.step(msa, "result2msa", [seq_db, seq_db, clu_db, msa], par)
    prof = wf.path("profile")
    wf.step(prof, "msa2profile", [msa, prof], par)
    aln = wf.path("aln")
    wf.step(aln, "align", [prof, seq_db, clu_db, aln], par)
    rep_map = {}
    best = {}
    with DBReader(aln) as r:
        for i in range(r.size):
            old = r.get_db_key(i)
            for line in r.get_data(i).decode().strip().split("\n"):
                if not line:
                    continue
                parts = line.split("\t")
                member, score = int(parts[0]), int(parts[1])
                if old not in best or score > best[old]:
                    best[old] = score
                    rep_map[old] = member
    _rewrite_clustering(rep_map, clu_db, out_db, par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def pickconsensusrepfast(par, command):
    """pickconsensusrepfast.sh: reuse <cluDB>_aln alignments through
    pickrepprofile instead of re-aligning."""
    seq_db, clu_db, out_db, tmp = par.filenames[:4]
    if not os.path.exists(clu_db + "_aln.dbtype"):
        log.die(f"{clu_db}_aln not found. Re-run linclust/cluster with "
                f"'--include-align-files 1 -a' so the "
                f"representative-to-member alignments are available.")
    wf = Workflow(tmp, par.force_reuse)
    rep = wf.path("rep_map")
    wf.step(rep, "pickrepprofile", [seq_db, clu_db + "_aln", rep], par)
    rep_map = {}
    with DBReader(rep) as r:
        for i in range(r.size):
            old = r.get_db_key(i)
            rep_map[old] = int(r.get_data(i).split(b"\t")[0])
    _rewrite_clustering(rep_map, clu_db, out_db, par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def easy_proteomecluster(par, command):
    """easyproteomecluster.sh (non-cascaded path): createdb -> cluster ->
    proteomecluster -> TSV reports."""
    fastas = par.filenames[:-2]
    results = par.filenames[-2]
    tmp = par.filenames[-1]
    wf = Workflow(tmp, par.force_reuse)
    inp = wf.path("input")
    wf.step(inp, "createdb", fastas + [inp], par)
    clu = wf.path("clu")
    module = "linclust" if par.cluster_module == 0 else "cluster"
    wf.step(clu, module, [inp, clu, wf.path("clu_tmp")], par)
    if not os.path.exists(results + "_protein_cluster.tsv"):
        wf.step_always("createtsv",
                       [inp, inp, clu, results + "_protein_cluster.tsv"],
                       par)
    aln_proteome = wf.path("aln_proteome")
    wf.step(aln_proteome, "proteomecluster",
            [inp, clu, aln_proteome, wf.path("cluster_count"),
             wf.path("aln_protein")], par)
    if not os.path.exists(results + "_cluster_count.tsv"):
        wf.step_always("createtsv",
                       [inp, wf.path("cluster_count"),
                        results + "_cluster_count.tsv"], par)
    if not os.path.exists(results + "_proteome_cluster.tsv"):
        wf.step_always("createtsv",
                       [inp, inp, aln_proteome,
                        results + "_proteome_cluster.tsv"], par)
    if par.include_align_files and \
            not os.path.exists(results + "_protein_align.tsv"):
        wf.step_always("createtsv",
                       [inp, inp, wf.path("aln_protein"),
                        results + "_protein_align.tsv"], par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def easy_proteomesearch(par, command):
    """easyproteomesearch.sh: createdb both sides -> search ->
    convertalis -> parseproteomealignments -> TSV."""
    q_fasta, t_fasta, out_file, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)
    qdb = wf.path("query")
    wf.step(qdb, "createdb", [q_fasta, qdb], par)
    if os.path.exists(t_fasta + ".dbtype"):
        tdb = t_fasta
    else:
        tdb = wf.path("target")
        wf.step(tdb, "createdb", [t_fasta, tdb], par)
    sr = wf.path("search_result")
    wf.step(sr, "search", [qdb, tdb, sr, wf.path("search_tmp")], par)
    if not os.path.exists(out_file + "_search.m8"):
        wf.step_always("convertalis",
                       [qdb, tdb, sr, out_file + "_search.m8"], par)
    inter = wf.path("parsealn_result")
    wf.step(inter, "parseproteomealignments", [qdb, tdb, sr, inter], par)
    if not os.path.exists(out_file + ".tsv"):
        wf.step_always("createtsv", [qdb, tdb, inter, out_file + ".tsv"],
                       par)
    wf.cleanup(par.remove_tmp_files)
    return 0
