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
(cascaded, with --cluster-reassign), v2 and --single-step-clustering, and
the clusterupdate workflow, with --switch-consensus-rep
(pickconsensusrepfast). Not yet ported (see ROADMAP.md), raising before any
step runs: profile DBs.
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
    with DBReader(seq_db) as r:
        if r.base_type not in (dbt.DBTYPE_AMINO_ACIDS,
                               dbt.DBTYPE_NUCLEOTIDES):
            _not_ported("clustering of a profile database")


def _switch_consensus_rep(par, wf, seq_db, out_db, keep_aln):
    """--switch-consensus-rep: pickconsensusrepfast over the clustering's
    rep->member alignments, which replaces out_db; the alignments go unless
    --include-align-files was set."""
    if not par.switch_consensus_rep:
        return
    switched = wf.path("clu_switched")
    wf.step(switched, "pickconsensusrepfast",
            [seq_db, out_db, switched, wf.path("switch_tmp")], par)
    for suf in ("", ".index", ".dbtype"):
        if os.path.exists(switched + suf):
            os.replace(switched + suf, out_db + suf)
    if not keep_aln:
        for suf in ("", ".index", ".dbtype"):
            if os.path.exists(out_db + "_aln" + suf):
                os.remove(out_db + "_aln" + suf)


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
    with optional clusthash pre-clustering and consensus-rep switching.

    Reference: data/workflow/linclust.sh:21-140 +
    src/workflow/Linclust.cpp:168-201 (first kmermatcher pass runs with
    spaced k-mers and masking off, the refinement pass with spaced k-mers
    on and --kmer-per-seq-scale 0.1)."""
    # --switch-consensus-rep reuses the rep->member alignments, so force
    # their creation (Linclust.cpp:54-64)
    keep_aln = par.was_set("include_align_files") and par.include_align_files
    if par.switch_consensus_rep:
        par.set("include_align_files", True)
        par.set("add_backtrace", True)
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
    _switch_consensus_rep(par, wf, seq_db, out_db, keep_aln)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _auto_sensitivity(seq_id_thr: float) -> float:
    if seq_id_thr <= 0.3:
        return 6.0
    if seq_id_thr > 0.8:
        return 1.0
    return 1.0 + (0.7 - seq_id_thr) * 10.0


def set_cluster_defaults(par):
    """setWorkflowDefaults (Cluster.cpp:13-20): the values that every step
    of `cluster`, --cluster-reassign's too, inherits unless set."""
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


def cluster(par, command):
    seq_db, out_db, tmp = par.filenames[:3]
    _refuse_unported(par, seq_db)
    wf = Workflow(tmp, par.force_reuse)
    if par.switch_consensus_rep and par.cluster_version != 2:
        # reference: only supported with align2clust-based cluster-version 2
        # (Cluster.cpp:143-147)
        log.warning("--switch-consensus-rep is only supported with "
                    "--cluster-version 2; ignoring. Run pickconsensusrep "
                    "on the result to switch representatives.")
    set_cluster_defaults(par)
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

    if par.cluster_reassign:
        clu = wf.path("clu")
        wf.step(clu, "mergeclusters",
                [seq_db, clu, clu_red] + clu_steps, par)
        _cluster_reassign(par, wf, seq_db, clu, out_db)
    elif not_exists(out_db):
        wf.step(out_db, "mergeclusters",
                [seq_db, out_db, clu_red] + clu_steps, par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _cluster_reassign(par, wf, seq_db, clu, out_db):
    """`--cluster-reassign`: correct cascaded-clustering errors by realigning
    every member against its representative, pulling out members that miss
    the clustering thresholds, and re-assigning them to their best-matching
    seed (reference data/workflow/cascaded_clustering.sh:161-283 +
    src/workflow/Cluster.cpp:256-268: reassign prefilter runs with the
    swapped coverage mode, align with the original)."""
    HUGE_E = ["--e-profile", "100000000", "-e", "100000000"]
    aln = wf.path("reassign_aln")
    wf.step(aln, "align", [seq_db, seq_db, clu, aln], par)
    not_acc = wf.path("clu_not_accepted")
    wf.step(not_acc, "subtractdbs", [clu, aln, not_acc] + HUGE_E, par)
    not_acc_swap = wf.path("clu_not_accepted_swap")
    wf.step(not_acc_swap, "swapdb", [not_acc, not_acc_swap], par)
    if os.path.getsize(not_acc_swap + ".index") == 0:
        # nothing to reassign
        for suf in ("", ".index", ".dbtype"):
            os.replace(clu + suf, out_db + suf)
        return
    acc = wf.path("clu_accepted")
    wf.step(acc, "subtractdbs", [clu, not_acc, acc] + HUGE_E, par)
    wrong = wf.path("seq_wrong_assigned")
    wf.step(wrong, "createsubdb", [not_acc_swap, seq_db, wrong], par)
    seeds = wf.path("seq_seeds")
    wf.step(seeds, "createsubdb", [clu, seq_db, seeds], par)

    # two-file merged seq DB: seeds then wrong-assigned, offsets shifted
    # (cascaded_clustering.sh:217-224)
    merged = wf.path("seq_seeds.merged")
    if not_exists(merged):
        max_off = 0
        lines = []
        with open(seeds + ".index", "rb") as f:
            for line in f:
                p = line.split(b"\t")
                max_off = max(max_off, int(p[1]) + int(p[2]))
                lines.append(line)
        with open(wrong + ".index", "rb") as f:
            for line in f:
                p = line.split(b"\t")
                lines.append(b"\t".join(
                    [p[0], str(int(p[1]) + max_off).encode(), p[2]]))
        with open(merged + ".index", "wb") as f:
            f.writelines(lines)
        for i, src in ((0, seeds), (1, wrong)):
            dst = f"{merged}.{i}"
            if os.path.lexists(dst):
                os.unlink(dst)
            os.symlink(os.path.abspath(src), dst)
        import shutil
        shutil.copyfile(seeds + ".dbtype", merged + ".dbtype")

    pref = wf.path("seq_wrong_assigned_pref")
    orig_cov = par.cov_mode
    par.set("cov_mode", {1: 2, 2: 1}.get(orig_cov, orig_cov))
    wf.step(pref, "prefilter", [wrong, merged, pref,
                                "-s", round(par.sensitivity, 3)], par)
    par.set("cov_mode", orig_cov)
    pref_swap = wf.path("seq_wrong_assigned_pref_swaped")
    wf.step(pref_swap, "swapdb", [pref, pref_swap], par)
    aln2 = wf.path("seq_wrong_assigned_pref_swaped_aln")
    wf.step(aln2, "align", [merged, wrong, pref_swap, aln2], par)
    ocol = aln2 + "_ocol"
    wf.step(ocol, "filterdb", [aln2, ocol, "--trim-to-one-column", 1], par)
    plus_wrong = wf.path("clu_accepted_plus_wrong")
    wf.step(plus_wrong, "mergedbs", [merged, plus_wrong, acc, ocol], par)

    # singletons that dropped out entirely (cascaded_clustering.sh:258-263)
    singles_tsv = wf.path("missing.single.seqs")
    singles = singles_tsv + ".db"
    if not_exists(singles):
        big = set()
        with open(plus_wrong + ".index", "rb") as f:
            for line in f:
                p = line.split(b"\t")
                if int(p[2]) > 1:
                    big.add(p[0])
        with open(seq_db + ".index", "rb") as f, \
                open(singles_tsv, "wb") as out:
            for line in f:
                k = line.split(b"\t")[0]
                if k not in big:
                    out.write(k + b"\t" + k + b"\n")
        wf.step(singles, "tsv2db",
                [singles_tsv, singles, "--output-dbtype", 6], par)
    plus_single = wf.path("clu_accepted_plus_wrong_plus_single")
    wf.step(plus_single, "mergedbs",
            [seq_db, plus_single, plus_wrong, singles], par)
    wf.step(out_db, "clust", [seq_db, plus_single, out_db], par)


def _cluster_v2(par, wf, seq_db, out_db):
    """cluster2 module: linclust redundancy pass -> prefilter over the
    representatives at the target sensitivity -> align2clust (gated on the
    redundancy pre-clusters) -> mergeclusters, with optional consensus-rep
    switching.  Reference data/workflow/cascaded_clustering.sh:50-107 +
    src/workflow/Cluster.cpp:269-288 (Cluster.cpp:270-276 derives the
    linclust-equivalent sensitivity from --min-seq-id)."""
    keep_aln = par.was_set("include_align_files") and par.include_align_files
    if par.switch_consensus_rep:
        # force alignment files for the rep switch (Cluster.cpp:61-64 analog)
        par.set("include_align_files", True)
        par.set("add_backtrace", True)
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
    # the inner linclust must not already switch representatives
    # (Cluster.cpp:277-282)
    prev_switch = par.switch_consensus_rep
    par.set("switch_consensus_rep", False)
    wf.step(clu_red, "linclust",
            [seq_db, clu_red, wf.path("linclust"),
             "--min-seq-id", par.min_seq_id, "-c", par.cov_thr,
             "--cov-mode", par.cov_mode, "-e", par.evalue,
             "--remove-tmp-files", int(par.remove_tmp_files)], par)
    par.set("switch_consensus_rep", prev_switch)

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
    _switch_consensus_rep(par, wf, seq_db, out_db, keep_aln)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def clusterupdate(par, command):
    """Incremental clustering update
    (reference data/workflow/update_clustering.sh + ClusterUpdate.cpp):
    diff the old and new sequence DBs, remap new keys past the old key
    space, attach new sequences to existing clusters by searching against
    representatives, and cluster the leftovers separately."""
    old_db, new_db, old_clust, new_map_db, new_clust, tmp = \
        par.filenames[:6]
    if not par.was_set("alignment_mode"):
        par.set("alignment_mode", 3)  # setClusterUpdateDefaults
    wf = Workflow(tmp, par.force_reuse)
    removed = wf.path("removedSeqs")
    mapping = wf.path("mappingSeqs")
    new_seqs = wf.path("newSeqs")
    if not os.path.exists(removed):
        wf.step_always("diffseqdbs", [old_db, new_db, removed, mapping,
                                      new_seqs], par)
    if os.path.getsize(mapping) == 0:
        log.warning(
            f"There are no common sequences between {old_db} and "
            f"{new_db}.\nIf you aim to add the sequences of {new_db} to "
            f"your previous clustering {old_clust}, concatdbs both DBs "
            f"and rerun clusterupdate.")
        for f in (removed, mapping, new_seqs):
            if os.path.exists(f):
                os.unlink(f)
        return 1

    def read_col(path, col=0):
        out = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    out.append(line.split()[col])
        return out

    if os.path.getsize(removed) > 0:
        if par.recover_deleted:
            rm_map = wf.path("OLDDB.removedMapping")
            if not os.path.exists(rm_map):
                highest = max(int(l.split("\t")[0]) for l in
                              open(new_db + ".index"))
                with open(rm_map, "w") as f, open(mapping, "a") as m:
                    for i, key in enumerate(read_col(removed)):
                        f.write(f"{key}\t{highest + 1 + i}\n")
                        m.write(f"{key}\t{highest + 1 + i}\n")
            wf.step(wf.path("OLDDB.removedDb"), "renamedbkeys",
                    [rm_map, old_db, wf.path("OLDDB.removedDb"),
                     "--subdb-mode", 1], par)
            wf.step(wf.path("NEWDB.withOld"), "concatdbs",
                    [new_db, wf.path("OLDDB.removedDb"),
                     wf.path("NEWDB.withOld"), "--preserve-keys", 1,
                     "--threads", 1], par)
            wf.step(wf.path("NEWDB.withOld_h"), "concatdbs",
                    [new_db + "_h", wf.path("OLDDB.removedDb_h"),
                     wf.path("NEWDB.withOld_h"), "--preserve-keys", 1,
                     "--threads", 1], par)
            new_db = wf.path("NEWDB.withOld")
        else:
            wf.step(wf.path("REMOVEDMEMBERS"), "createsubdb",
                    [removed, old_clust, wf.path("REMOVEDMEMBERS"),
                     "--subdb-mode", 0], par)
            wf.step(wf.path("REMOVEDMEMBERS.withoutDeleted"), "filterdb",
                    [wf.path("REMOVEDMEMBERS"),
                     wf.path("REMOVEDMEMBERS.withoutDeleted"),
                     "--filter-file", removed, "--positive-filter", 0],
                    par)
            tsv = wf.path("REMOVEDMEMBERS.tsv")
            if not os.path.exists(tsv):
                wf.step_always(
                    "prefixid",
                    [wf.path("REMOVEDMEMBERS.withoutDeleted"),
                     wf.path("REMOVEDMEMBERS.withoutDeleted.tsv"),
                     "--tsv", 1], par)
                with open(tsv, "w") as f:
                    for tok in read_col(
                            wf.path("REMOVEDMEMBERS.withoutDeleted.tsv"),
                            1):
                        f.write(tok + "\n")
            wf.step(wf.path("OLCLUST.withoutDeletedKeys"), "createsubdb",
                    [mapping, old_clust,
                     wf.path("OLCLUST.withoutDeletedKeys"),
                     "--subdb-mode", 1], par)
            wf.step(wf.path("OLCLUST.withoutDeleted"), "filterdb",
                    [wf.path("OLCLUST.withoutDeletedKeys"),
                     wf.path("OLCLUST.withoutDeleted"),
                     "--filter-file", removed, "--positive-filter", 0],
                    par)
            old_clust = wf.path("OLCLUST.withoutDeleted")

    new_mapping = wf.path("newMappingSeqs")
    if not os.path.exists(new_mapping):
        max_id = 0
        for idx in (old_db + ".index", new_db + ".index"):
            for line in open(idx):
                max_id = max(max_id, int(line.split("\t")[0]))
        with open(wf.path("newSeqs.mapped"), "w") as f:
            keys = read_col(new_seqs)
            for i, key in enumerate(keys):
                f.write(f"{key}\t{max_id + 1 + i}\n")
        with open(new_mapping, "w") as out:
            for line in open(mapping):
                a, b = line.split()[:2]
                out.write(f"{b}\t{a}\n")
            out.write(open(wf.path("newSeqs.mapped")).read())
        with open(new_seqs, "w") as f:
            for tok in read_col(wf.path("newSeqs.mapped"), 1):
                f.write(tok + "\n")
    wf.step(new_map_db, "renamedbkeys", [new_mapping, new_db, new_map_db],
            par)
    new_db = new_map_db

    newseq_file = new_seqs
    if os.path.getsize(removed) > 0 and not par.recover_deleted:
        newseq_file = wf.path("newSeqs.withMembers")
        if not os.path.exists(newseq_file):
            with open(newseq_file, "w") as f:
                f.write(open(wf.path("REMOVEDMEMBERS.tsv")).read())
                f.write(open(new_seqs).read())
    wf.step(wf.path("NEWDB.newSeqs"), "createsubdb",
            [newseq_file, new_db, wf.path("NEWDB.newSeqs"),
             "--subdb-mode", 1], par)
    wf.step(wf.path("OLDDB.repSeq"), "result2repseq",
            [old_db, old_clust, wf.path("OLDDB.repSeq")], par)
    # SEARCH_PAR forces --max-accept 1 (ClusterUpdate.cpp:70-74): each
    # new sequence attaches to at most its best representative
    wf.step(wf.path("newSeqsHits"), "search",
            [wf.path("NEWDB.newSeqs"), wf.path("OLDDB.repSeq"),
             wf.path("newSeqsHits"), wf.path("search"),
             "--max-accept", 1], par)
    wf.step(wf.path("newSeqsHits.swapped.all"), "swapdb",
            [wf.path("newSeqsHits"), wf.path("newSeqsHits.swapped.all")],
            par)
    has_hits = any(int(l.split("\t")[2]) > 1 for l in
                   open(wf.path("newSeqsHits.swapped.all.index")))
    updated_clust = old_clust
    if has_hits:
        wf.step(wf.path("newSeqsHits.swapped"), "filterdb",
                [wf.path("newSeqsHits.swapped.all"),
                 wf.path("newSeqsHits.swapped"),
                 "--trim-to-one-column", 1], par)
        wf.step(wf.path("updatedClust"), "mergedbs",
                [old_clust, wf.path("updatedClust"), old_clust,
                 wf.path("newSeqsHits.swapped")], par)
        updated_clust = wf.path("updatedClust")

    no_hit_list = wf.path("noHitSeqList")
    if not os.path.exists(no_hit_list):
        with open(no_hit_list, "w") as f:
            for line in open(wf.path("newSeqsHits.index")):
                parts = line.split("\t")
                if int(parts[2]) == 1:
                    f.write(parts[0] + "\n")
    wf.step(wf.path("toBeClusteredSeparately"), "createsubdb",
            [no_hit_list, new_db, wf.path("toBeClusteredSeparately"),
             "--subdb-mode", 1], par)
    separately = os.path.getsize(
        wf.path("toBeClusteredSeparately") + ".index") > 0
    if separately:
        wf.step(wf.path("newClusters"), "cluster",
                [wf.path("toBeClusteredSeparately"),
                 wf.path("newClusters"), wf.path("cluster")], par)
        wf.step(new_clust, "concatdbs",
                [updated_clust, wf.path("newClusters"), new_clust,
                 "--preserve-keys", 1], par)
    else:
        wf.step(new_clust, "mvdb", [updated_clust, new_clust], par)
    wf.cleanup(par.remove_tmp_files)
    return 0
