"""`linclust` and `cluster` workflows.

Reference: data/workflow/linclust.sh (v1 path), cascaded_clustering.sh +
src/workflow/Linclust.cpp / Cluster.cpp parameter wiring:
  - linclust v1: kmermatcher -> hamming rescorediagonal (cov/seqid >= 0.5
    floor) -> clust (pre-cluster) -> subset reps both sides -> substitution
    rescorediagonal --filter-hits -> align -> clust -> mergeclusters
  - cluster (cascaded, cluster1): linclust redundancy pass (reduced alphabet)
    -> STEPS x [prefilter(-s 1 .. target) -> align -> clust] on shrinking rep
    sets -> mergeclusters; step 0 runs with --diag-score 0
    --comp-bias-corr 0 --min-ungapped-score 0 (Cluster.cpp:223-232)
  - auto sensitivity from --min-seq-id (Cluster.cpp:23-32), auto step count

Port of mmseqs2_tpu/commands/cluster_wf.py for protein and nucleotide
sequence DBs: linclust v1 and v2 (with --clust-hash), cluster v1
(cascaded), v2 and --single-step-clustering. Not yet ported (see
ROADMAP.md), each raising before any step runs: --cluster-reassign (needs
swapdb and tsv2db), --switch-consensus-rep (needs pickconsensusrepfast),
profile DBs, and the clusterupdate workflow (diffseqdbs, renamedbkeys,
prefixid), which the registry does not list.
"""

import os

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..utils import log
from ..workflow import Workflow
from ..workflow.engine import not_exists


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def _refuse_unported(par, seq_db):
    """Raise for the branches the port does not run yet, before any step."""
    if par.switch_consensus_rep:
        _not_ported("--switch-consensus-rep (pickconsensusrepfast)")
    with DBReader(seq_db) as r:
        if r.base_type not in (dbt.DBTYPE_AMINO_ACIDS,
                               dbt.DBTYPE_NUCLEOTIDES):
            _not_ported("clustering of a profile database")


def _write_rep_order(clu_path, out_file):
    with open(clu_path + ".index") as f, open(out_file, "w") as o:
        for line in f:
            o.write(line.split("\t")[0] + "\n")


def linclust(par, command):
    seq_db, out_db, tmp = par.filenames[:4] if len(par.filenames) > 3 else \
        par.filenames[:3]
    _refuse_unported(par, seq_db)
    wf = Workflow(tmp, par.force_reuse)

    # setLinclustWorkflowDefaults (Linclust.cpp:12-21): cov 0.8, seqid 0.9,
    # e 1e-3, mask off, no spaced k-mers, alignment mode 3
    if not par.was_set("cov_thr"):
        par.set("cov_thr", 0.8)
    if not par.was_set("min_seq_id"):
        par.set("min_seq_id", 0.9)
    if not par.was_set("alignment_mode"):
        par.set("alignment_mode", 3)
    if not par.was_set("evalue"):
        par.set("evalue", 1e-3)
    if not par.was_set("mask"):
        par.set("mask", 0)
    if not par.was_set("spaced_kmer_mode"):
        par.set("spaced_kmer_mode", 0)

    # the workflow serializes current values explicitly
    # (createParameterString), so the k-mer stage sees --kmer-per-seq 21
    # (the global default) rather than the standalone command's 20
    if par.linclust_version == 2:
        # reference-default linclust2 module (align2clust chain)
        return _linclust_v2(par, wf, seq_db, out_db)
    pref = wf.path("pref")
    wf.step(pref, "kmermatcher",
            [seq_db, pref, "--kmer-per-seq", par.kmer_per_seq,
             "--min-seq-id", par.min_seq_id, "-c", par.cov_thr,
             "--cov-mode", par.cov_mode, "--linclust-version", 1], par)

    # hamming pre-clustering with >= 0.5 floors (Linclust.cpp:137-144)
    resc1 = wf.path("pref_rescore1")
    wf.step(resc1, "rescorediagonal",
            [seq_db, seq_db, pref, resc1, "--rescore-mode", 0,
             "--min-seq-id", max(0.5, par.min_seq_id),
             "-c", max(0.5, par.cov_thr), "--cov-mode", par.cov_mode], par)
    pre_clust = wf.path("pre_clust")
    wf.step(pre_clust, "clust", [seq_db, resc1, pre_clust], par)

    order = wf.path("order_redundancy")
    if not os.path.exists(order):
        _write_rep_order(pre_clust, order)
    input_red = wf.path("input_step_redundancy")
    wf.step(input_red, "createsubdb", [order, seq_db, input_red], par)
    wf.step(input_red + "_h", "createsubdb",
            [order, seq_db + "_h", input_red + "_h"], par)
    pref_f1 = wf.path("pref_filter1")
    wf.step(pref_f1, "createsubdb", [order, pref, pref_f1], par)
    pref_f2 = wf.path("pref_filter2")
    wf.step(pref_f2, "filterdb",
            [pref_f1, pref_f2, "--filter-file", order], par)

    # ungapped substitution rescoring with precision filter, amino acid DBs
    # only: nucleotide DBs align the unfiltered candidate list
    # (Linclust.cpp:129 "do not filter for nucl, profiles")
    with DBReader(seq_db) as r:
        is_aa = r.base_type == dbt.DBTYPE_AMINO_ACIDS
    if is_aa:
        resc2 = wf.path("pref_rescore2")
        wf.step(resc2, "rescorediagonal",
                [input_red, input_red, pref_f2, resc2, "--rescore-mode", 1,
                 "--filter-hits", 1, "--min-seq-id", par.min_seq_id,
                 "-c", par.cov_thr, "--cov-mode", par.cov_mode,
                 "-e", par.evalue], par)
    else:
        resc2 = pref_f2

    aln = wf.path("aln")
    wf.step(aln, "align",
            [input_red, input_red, resc2, aln, "--alignment-mode",
             par.alignment_mode, "-e", par.evalue, "--min-seq-id",
             par.min_seq_id, "-c", par.cov_thr, "--cov-mode",
             par.cov_mode], par)
    clust_db = wf.path("clust")
    wf.step(clust_db, "clust", [input_red, aln, clust_db], par)

    if not_exists(out_db):
        wf.step(out_db, "mergeclusters",
                [seq_db, out_db, pre_clust, clust_db], par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _linclust_v2(par, wf, seq_db, out_db):
    """linclust2 module: kmermatcher (v2 center-swapping chain) ->
    align2clust -> representative refinement pass -> mergeclusters,
    with optional clusthash pre-clustering.

    Reference: data/workflow/linclust.sh:21-140 +
    src/workflow/Linclust.cpp:168-201 (first kmermatcher pass runs with
    spaced k-mers and masking off, the refinement pass with spaced k-mers
    on and --kmer-per-seq-scale 0.1)."""
    source = seq_db
    cur = seq_db
    clusthash_clu = None
    if par.clust_hash:
        ch = wf.path("input_clusthash")
        orig_id = par.min_seq_id
        par.set("min_seq_id", max(0.9, orig_id))
        wf.step(ch, "clusthash", [cur, ch], par)
        par.set("min_seq_id", orig_id)
        clusthash_clu = wf.path("input_clusthash_clust")
        wf.step(clusthash_clu, "clust", [cur, ch, clusthash_clu], par)
        order = wf.path("order_clusthash_redundancy")
        if not os.path.exists(order):
            _write_rep_order(clusthash_clu, order)
        red = wf.path("input_clusthash_redundancy")
        wf.step(red, "createsubdb",
                [order, source, red, "--subdb-mode", 1], par)
        wf.step(red + "_h", "createsubdb",
                [order, source + "_h", red + "_h"], par)
        cur = red

    pref = wf.path("pref")
    wf.step(pref, "kmermatcher",
            [cur, pref, "--spaced-kmer-mode", 0, "--mask", 0], par)
    clu = wf.path("clu")
    wf.step(clu, "align2clust", [cur, pref, clu], par)
    if clusthash_clu is not None:
        clu_merged = wf.path("clu_merged")
        wf.step(clu_merged, "mergeclusters",
                [source, clu_merged, clusthash_clu, clu], par)
        cludb = clu_merged
    else:
        cludb = clu

    # refinement pass over the representatives
    rep_order = wf.path("order_rep")
    if not os.path.exists(rep_order):
        _write_rep_order(cludb, rep_order)
    input_rep = wf.path("input_rep")
    wf.step(input_rep, "createsubdb",
            [rep_order, cur, input_rep, "--subdb-mode", 1], par)
    wf.step(input_rep + "_h", "createsubdb",
            [rep_order, cur + "_h", input_rep + "_h"], par)
    pref_rep = wf.path("pref_rep")
    wf.step(pref_rep, "kmermatcher",
            [input_rep, pref_rep, "--spaced-kmer-mode", 1,
             "--kmer-per-seq-scale", "0.1"], par)
    clu_rep = wf.path("clu_rep")
    wf.step(clu_rep, "align2clust",
            [input_rep, pref_rep, clu_rep,
             "--filter-cludb-file", cludb,
             "--filter-seqdb-file", source], par)
    wf.step(out_db, "mergeclusters", [source, out_db, cludb, clu_rep], par)

    # union the per-pass alignment files keyed by the final representatives
    if os.path.exists(clu_rep + "_aln.dbtype"):
        if os.path.exists(clu + "_aln.dbtype"):
            wf.step(out_db + "_aln", "mergedbs",
                    [out_db, out_db + "_aln", clu + "_aln", clu_rep + "_aln",
                     "--merge-filter-target", 1], par)
        else:
            for suf in ("", ".index", ".dbtype"):
                if os.path.exists(clu_rep + "_aln" + suf):
                    os.replace(clu_rep + "_aln" + suf,
                               out_db + "_aln" + suf)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _auto_sensitivity(seq_id_thr: float) -> float:
    if seq_id_thr <= 0.3:
        return 6.0
    if seq_id_thr > 0.8:
        return 1.0
    return 1.0 + (0.7 - seq_id_thr) * 10.0


def cluster(par, command):
    seq_db, out_db, tmp = par.filenames[:3]
    if par.cluster_reassign:
        _not_ported("cluster --cluster-reassign (swapdb, tsv2db)")
    _refuse_unported(par, seq_db)
    wf = Workflow(tmp, par.force_reuse)

    # setWorkflowDefaults (Cluster.cpp:13-20)
    if not par.was_set("cov_thr"):
        par.set("cov_thr", 0.8)
    if not par.was_set("evalue"):
        par.set("evalue", 1e-3)
    if not par.was_set("alignment_mode"):
        par.set("alignment_mode", 3)
    if not par.was_set("max_seqs"):
        par.set("max_seqs", 20)
    if not par.was_set("sensitivity"):
        par.set("sensitivity", _auto_sensitivity(par.min_seq_id))
        log.info(f"Set cluster sensitivity to -s {par.sensitivity}")
    steps = par.cluster_steps if par.was_set("cluster_steps") else (
        1 if par.sensitivity <= 2.0 else 3)
    log.info(f"Set cluster iterations to {steps}")

    if par.cluster_version == 2 and not par.single_step_clustering:
        return _cluster_v2(par, wf, seq_db, out_db)

    if par.single_step_clustering:
        pref = wf.path("pref")
        wf.step(pref, "prefilter", [seq_db, seq_db, pref, "-s",
                                    par.sensitivity], par)
        aln = wf.path("aln")
        wf.step(aln, "align", [seq_db, seq_db, pref, aln], par)
        wf.step(out_db, "clust", [seq_db, aln, out_db], par)
        if par.remove_tmp_files:
            wf.cleanup(True)
        return 0

    # cascaded: linclust redundancy pass first. The reference serializes the
    # cluster-level values explicitly (Cluster.cpp LINCLUST_PAR), overriding
    # linclust's own defaults: --min-seq-id 0 (cluster default),
    # --spaced-kmer-mode 1, --mask 0, alph 13, k auto
    clu_red = wf.path("clu_redundancy")
    lin_tmp = wf.path("linclust")
    wf.step(clu_red, "linclust",
            [seq_db, clu_red, lin_tmp,
             "--min-seq-id", par.min_seq_id, "-c", par.cov_thr,
             "--cov-mode", par.cov_mode, "-e", par.evalue,
             "--alignment-mode", par.alignment_mode,
             "--spaced-kmer-mode", par.spaced_kmer_mode,
             "--kmer-per-seq", par.kmer_per_seq, "--mask", 0,
             "--cluster-mode", par.cluster_mode,
             "--remove-tmp-files", int(par.remove_tmp_files)], par)

    order = wf.path("order_redundancy")
    if not os.path.exists(order):
        _write_rep_order(clu_red, order)
    cur_input = wf.path("input_step_redundancy")
    wf.step(cur_input, "createsubdb", [order, seq_db, cur_input], par)
    wf.step(cur_input + "_h", "createsubdb",
            [order, seq_db + "_h", cur_input + "_h"], par)

    target_sens = par.sensitivity
    clu_steps = []
    for step in range(steps):
        if steps > 1:
            sens = 1.0 if step == 0 else \
                1.0 + (target_sens - 1.0) / (steps - 1) * step
        else:
            sens = target_sens
        pref = wf.path(f"pref_step{step}")
        common = ["-c", par.cov_thr, "--cov-mode", par.cov_mode,
                  "--max-seqs", par.max_seqs]
        aln_common = ["--alignment-mode", par.alignment_mode,
                      "-e", par.evalue, "--min-seq-id", par.min_seq_id,
                      "-c", par.cov_thr, "--cov-mode", par.cov_mode]
        extra = []
        if step == 0 and steps > 1:
            extra = ["--diag-score", 0, "--comp-bias-corr", 0,
                     "--min-ungapped-score", 0]
            aln_common += ["--comp-bias-corr", 0]
        wf.step(pref, "prefilter",
                [cur_input, cur_input, pref, "-s", round(sens, 3)]
                + common + extra, par)
        aln = wf.path(f"aln_step{step}")
        wf.step(aln, "align",
                [cur_input, cur_input, pref, aln] + aln_common, par)
        clu = wf.path(f"clu_step{step}")
        wf.step(clu, "clust", [cur_input, aln, clu], par)
        clu_steps.append(clu)
        if step < steps - 1:
            next_order = wf.path(f"order_step{step + 1}")
            if not os.path.exists(next_order):
                _write_rep_order(clu, next_order)
            next_input = wf.path(f"input_step{step + 1}")
            wf.step(next_input, "createsubdb",
                    [next_order, cur_input, next_input], par)
            wf.step(next_input + "_h", "createsubdb",
                    [next_order, cur_input + "_h", next_input + "_h"], par)
            cur_input = next_input

    if not_exists(out_db):
        wf.step(out_db, "mergeclusters",
                [seq_db, out_db, clu_red] + clu_steps, par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _cluster_v2(par, wf, seq_db, out_db):
    """cluster2 module: linclust redundancy pass -> prefilter over the
    representatives at the target sensitivity -> align2clust (gated on the
    redundancy pre-clusters) -> mergeclusters, with optional consensus-rep
    switching.  Reference data/workflow/cascaded_clustering.sh:50-107 +
    src/workflow/Cluster.cpp:269-288 (Cluster.cpp:270-276 derives the
    linclust-equivalent sensitivity from --min-seq-id)."""
    # v2 derives its own sensitivity from --min-seq-id, overriding -s
    # (Cluster.cpp:269-276 has no wasSet guard)
    if par.min_seq_id >= 0.7:
        sens = 0.0
    elif par.min_seq_id <= 0.3:
        sens = 3.0 + 10.0 * (0.3 - par.min_seq_id)
    else:
        sens = 3.0 * (0.7 - par.min_seq_id) / (0.7 - 0.3)
    par.set("sensitivity", sens)
    clu_red = wf.path("clu_redundancy")
    wf.step(clu_red, "linclust",
            [seq_db, clu_red, wf.path("linclust"),
             "--min-seq-id", par.min_seq_id, "-c", par.cov_thr,
             "--cov-mode", par.cov_mode, "-e", par.evalue,
             "--remove-tmp-files", int(par.remove_tmp_files)], par)

    order = wf.path("order_redundancy")
    if not os.path.exists(order):
        _write_rep_order(clu_red, order)
    cur = wf.path("input_step_redundancy")
    wf.step(cur, "createsubdb", [order, seq_db, cur, "--subdb-mode", 1],
            par)
    wf.step(cur + "_h", "createsubdb",
            [order, seq_db + "_h", cur + "_h"], par)

    pref = wf.path("pref_rep")
    wf.step(pref, "prefilter",
            [cur, cur, pref, "-s", round(par.sensitivity, 3)], par)
    clu2 = wf.path("clu2_rep")
    wf.step(clu2, "align2clust",
            [cur, pref, clu2, "--filter-cludb-file", clu_red,
             "--filter-seqdb-file", seq_db], par)
    wf.step(out_db, "mergeclusters", [seq_db, out_db, clu_red, clu2], par)

    if os.path.exists(clu2 + "_aln.dbtype"):
        if os.path.exists(clu_red + "_aln.dbtype"):
            wf.step(out_db + "_aln", "mergedbs",
                    [out_db, out_db + "_aln", clu_red + "_aln",
                     clu2 + "_aln", "--merge-filter-target", 1], par)
        else:
            for suf in ("", ".index", ".dbtype"):
                if os.path.exists(clu2 + "_aln" + suf):
                    os.replace(clu2 + "_aln" + suf, out_db + "_aln" + suf)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0
