"""`search` workflow: prefilter -> align (blastp.sh equivalent).

Port of mmseqs2_tpu/commands/search.py: the protein-vs-protein path with
single and multi sensitivity stepping, the iterative profile search
(--num-iterations, blastpgp.sh), sequence queries against profile targets
(searchtargetprofile.sh), the sliced search (--exhaustive-search,
searchslicedtargetprofile.sh), the translated search (translated_search.sh),
the nucleotide search (--search-type 3, blastn.sh) and the profile
enrichment workflow `enrich` (enrich.sh). Reference:
src/workflow/Search.cpp (mode matrix :33-123, parameter wiring :544-629) +
data/workflow/blastp.sh.
--prefilter-mode: 0 k-mer index (default), 1 exhaustive ungapped, 2
exhaustive (all-vs-all fake prefilter), mirroring Parameters::PREF_MODE_*;
1 and 2 both run `ungappedprefilter`, as in the JAX package.
--prefilter-mode 3 is not yet ported (see ROADMAP.md) and raises.
--lca-search runs `lcaalign` in place of `align` (the taxonomy search);
--alignment-mode 4 runs `rescorediagonal`.
"""

import os
import shutil

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from ..workflow import Workflow
from ..workflow.engine import not_exists
from .kmermatcher import _parse_mem_limit

PREF_MODE_KMER = 0
PREF_MODE_UNGAPPED = 1
PREF_MODE_EXHAUSTIVE = 2
PREF_COMMANDS = {PREF_MODE_KMER: "prefilter",
                 PREF_MODE_UNGAPPED: "ungappedprefilter",
                 PREF_MODE_EXHAUSTIVE: "ungappedprefilter"}


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def search(par, command):
    qdb, tdb, out_aln, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)

    q_type = DBReader(qdb).base_type
    t_type = DBReader(tdb).base_type
    t_profile = (t_type == dbt.DBTYPE_HMM_PROFILE
                 and q_type != dbt.DBTYPE_HMM_PROFILE)
    q_nucl = q_type == dbt.DBTYPE_NUCLEOTIDES
    t_nucl = t_type == dbt.DBTYPE_NUCLEOTIDES
    both_nucl = q_nucl and t_nucl

    # EasySearch/Search set SCORE_COV_SEQID; plain search defaults SCORE_COV
    if not par.was_set("alignment_mode") and not par.add_backtrace:
        par.set("alignment_mode", 2)

    # --exhaustive-search: sliced inverted search (Search.cpp:357-399)
    if par.exhaustive_search:
        return _search_sliced(par, wf, qdb, tdb, out_aln)

    # target-profile search (searchtargetprofile.sh): prefilter against the
    # profile-target index, align in the swapped (profile-query) direction,
    # swap back (Search.cpp:453-476). The prefilter runs at its own default
    # sensitivity (the workflow passes no -s).
    if t_profile and not par.was_set("sensitivity"):
        return _search_target_profile(par, wf, qdb, tdb, out_aln)

    # search raises the default prefilter sensitivity (Search.cpp:24)
    if not par.was_set("sensitivity"):
        par.set("sensitivity", 5.7)
    if t_profile:
        return _search_target_profile(par, wf, qdb, tdb, out_aln)

    if both_nucl and par.search_type == 3:
        return _search_nucl(par, wf, qdb, tdb, out_aln)
    if both_nucl and par.search_type == 0:
        log.die("Searching with nucleotide query and target database "
                "requires --search-type 2 (translated) or 3 (nucleotide)")
    if (q_nucl or t_nucl) and (par.search_type in (0, 2) or both_nucl):
        return _search_translated(par, wf, qdb, tdb, out_aln,
                                  q_nucl, t_nucl)
    if par.num_iterations > 1:
        return _search_iterative(par, wf, qdb, tdb, out_aln)
    if par.prefilter_mode not in PREF_COMMANDS:
        _not_ported(f"search --prefilter-mode {par.prefilter_mode}")

    sens_steps = par.sens_steps if par.was_set("start_sens") else 1
    target_sens = par.sensitivity
    start_sens = min(par.start_sens, target_sens)
    pref_cmd = PREF_COMMANDS[par.prefilter_mode]

    align_module = "lcaalign" if par.lca_search else "align"
    # ALIGNMENT_MODE_UNGAPPED (4): replace align with rescorediagonal
    # --rescore-mode 2 (Search.cpp:261,314; map.sh path)
    if par.alignment_mode == 4:
        align_module = "rescorediagonal"
        if not par.was_set("rescore_mode"):
            par.set("rescore_mode", 2)

    if sens_steps <= 1:
        pref = wf.path("pref_0")
        wf.step(pref, pref_cmd, [qdb, tdb, pref, "-s", target_sens], par)
        wf.step(out_aln, align_module, [qdb, tdb, pref, out_aln], par)
    else:
        # blastp.sh multi-step: search remaining queries at increasing
        # sensitivity, merge per-step alignment results
        # (reference data/workflow/blastp.sh:97-150)
        aln_steps = []
        current_q = qdb
        for step_i in range(sens_steps):
            sens = start_sens + (target_sens - start_sens) * step_i / max(
                1, sens_steps - 1)
            pref = wf.path(f"pref_{step_i}")
            aln = wf.path(f"aln_{step_i}")
            wf.step(pref, pref_cmd, [current_q, tdb, pref, "-s",
                                     round(sens, 2)], par)
            wf.step(aln, "align", [current_q, tdb, pref, aln], par)
            aln_steps.append(aln)
            if step_i < sens_steps - 1:
                # queries without any hit continue to the next step
                next_q = wf.path(f"q_{step_i + 1}")
                if not_exists(next_q):
                    _subset_unmatched(current_q, aln, next_q)
                current_q = next_q
        if not_exists(out_aln):
            _merge_alignments(qdb, aln_steps, out_aln)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _search_translated(par, wf, qdb, tdb, out_aln, q_nucl, t_nucl):
    """Translated search (data/workflow/translated_search.sh): extract +
    translate ORFs on each nucleotide side, search in protein space, map
    alignments back to nucleotide coordinates (*3) via offsetalignment."""
    query = query_orf = qdb
    if q_nucl:
        q_orfs = wf.path("q_orfs_aa")
        wf.step(q_orfs, "extractorfs", [qdb, q_orfs, "--translate", "1"],
                par)
        query = query_orf = q_orfs
    target = target_orf = tdb
    if t_nucl:
        t_orfs = wf.path("t_orfs_aa")
        wf.step(t_orfs, "extractorfs", [tdb, t_orfs, "--translate", "1"],
                par)
        target = target_orf = t_orfs

    pref = wf.path("pref")
    wf.step(pref, "prefilter", [query, target, pref, "-s", par.sensitivity],
            par)
    aln = wf.path("aln")
    wf.step(aln, "align", [query, target, pref, aln], par)
    wf.step(out_aln, "offsetalignment",
            [qdb, query_orf, tdb, target_orf, aln, out_aln,
             "--search-type", "2" if par.search_type == 0
             else par.search_type], par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _search_nucl(par, wf, qdb, tdb, out_aln):
    """Nucleotide/nucleotide search (data/workflow/blastn.sh +
    setNuclSearchDefaults, Search.cpp:180-200,595-626): split long target
    and query sequences, extract query strand frames, run the k-mer
    prefilter + banded ksw2 alignment, map coordinates back."""
    # setNuclSearchDefaults (unconditional unless ungapped mode)
    if par.alignment_mode != 4:
        par.set("alignment_mode", 3)
    strand = par.strand if par.was_set("strand") else 2
    kmer = par.kmer_size if par.was_set("kmer_size") else 15
    max_seq_len = par.max_seq_len if par.was_set("max_seq_len") else 10000

    target = tdb
    tsplit = wf.path("target_seqs_split")
    wf.step(tsplit, "splitsequence",
            [tdb, tsplit, "--max-seq-len", max_seq_len,
             "--sequence-overlap", par.sequence_overlap], par)
    target = tsplit

    query = qdb
    if strand in (0, 2):
        frames = wf.path("query_seqs")
        fwd = "1" if strand == 2 else ""
        wf.step(frames, "extractframes",
                [query, frames, "--forward-frames", fwd,
                 "--reverse-frames", "1"], par)
        query = frames
    qsplit = wf.path("query_seqs_split")
    wf.step(qsplit, "splitsequence",
            [query, qsplit, "--max-seq-len", max_seq_len,
             "--sequence-overlap", par.sequence_overlap], par)
    query = qsplit

    pref = wf.path("pref")
    wf.step(pref, "prefilter",
            [query, target, pref, "-k", kmer, "--exact-kmer-matching", "1",
             "--max-seq-len", max_seq_len, "-s", par.sensitivity], par)
    aln = wf.path("aln")
    wf.step(aln, "align",
            [query, target, pref, aln, "--alignment-mode",
             par.alignment_mode, "--max-seq-len", max_seq_len], par)
    wf.step(out_aln, "offsetalignment",
            [qdb, query, tdb, target, aln, out_aln], par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _subset_unmatched(qdb_path, aln_path, out_path):
    """createsubdb of queries with empty alignment entries."""
    aln = DBReader(aln_path)
    q = DBReader(qdb_path)
    qh = DBReader(qdb_path + "_h")
    with DBWriter(out_path, q.base_type, q.extended_type) as w, \
            DBWriter(out_path + "_h", qh.base_type, qh.extended_type) as wh:
        for i in range(aln.size):
            key = aln.get_db_key(i)
            if len(aln.get_data(i)) == 0:
                w.write(key, q.get_data(q.get_id(key)))
                wh.write(key, qh.get_data(qh.get_id(key)))
    aln.close()
    q.close()
    qh.close()


def _merge_alignments(qdb_path, aln_paths, out_path):
    """Concatenate per-step alignment entries per query key."""
    readers = [DBReader(p) for p in aln_paths]
    q = DBReader(qdb_path)
    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES) as w:
        for i in range(q.size):
            key = q.get_db_key(i)
            chunks = []
            for r in readers:
                j = r.get_id(key)
                if j >= 0:
                    chunks.append(r.get_data(j))
            w.write(key, b"".join(chunks))
    for r in readers:
        r.close()
    q.close()


def _search_iterative(par, wf, qdb, tdb, out_aln):
    """PSI-BLAST-style iterative profile search.

    Reference: data/workflow/blastpgp.sh + Search.cpp:477-525. Per
    iteration: prefilter -> subtract previously-aligned targets -> align ->
    merge into the running alignment set -> result2profile becomes the next
    query. Iteration 0 aligns with --realign; intermediate iterations use
    min(-e, --e-profile) as the alignment E-value threshold; the last
    restores the caller's -e. subtractdbs keeps the pre-loop threshold
    (SUBSTRACT_PAR is built before the E-value override, Search.cpp:478).
    """
    num_it = par.num_iterations
    original_eval = par.evalue
    eval_profile = min(par.evalue, par.e_profile)

    current_q = qdb
    for step in range(num_it):
        last = step == num_it - 1
        step_eval = original_eval if last else eval_profile

        if step == 0:
            pref = wf.path("pref_0")
            wf.step(pref, "prefilter",
                    [current_q, tdb, pref, "-s", par.sensitivity], par)
        else:
            pref_tmp = wf.path(f"pref_tmp_{step}")
            wf.step(pref_tmp, "prefilter",
                    [current_q, tdb, pref_tmp, "-s", par.sensitivity], par)
            pref = wf.path(f"pref_{step}")
            wf.step(pref, "subtractdbs",
                    [pref_tmp, wf.path(f"aln_{step - 1}"), pref,
                     "-e", original_eval, "--e-profile", par.e_profile],
                    par)

        aln_tmp = wf.path("aln_0" if step == 0 else f"aln_tmp_{step}")
        align_args = [current_q, tdb, pref, aln_tmp,
                      "-e", step_eval, "-a", "1",
                      "--realign", "1" if step == 0 else "0"]
        wf.step(aln_tmp, "align", align_args, par)

        if step == 0:
            aln = aln_tmp
        else:
            aln = out_aln if last else wf.path(f"aln_{step}")
            wf.step(aln, "mergedbs",
                    [current_q, aln, wf.path(f"aln_{step - 1}"), aln_tmp],
                    par)

        if not last:
            profdb = wf.path(f"profile_{step}")
            wf.step(profdb, "result2profile",
                    [current_q, tdb, aln, profdb, "-e", eval_profile], par)
            current_q = profdb

    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _search_sliced(par, wf, qdb, tdb, out_aln):
    """`--exhaustive-search`: sliced inverted search through a large target
    (typically profile) DB.

    Reference: data/workflow/searchslicedtargetprofile.sh +
    src/workflow/Search.cpp:357-399.  The evalue threshold is corrected by
    |Q|/|T| for the inverted direction, the coverage mode is swapped, and
    the prefilter max result list is max(300, |Q|).  The target index is
    processed in disk-budgeted slices: prefilter slice-vs-query, align in
    cluster-output mode, optionally filterresult, merge.  A final align
    (top max-seqs per target) and swapresults (no evalue cut) restore the
    query direction.
    """
    if not par.was_set("sensitivity"):
        par.set("sensitivity", 5.7)
    q_size = sum(1 for _ in open(qdb + ".index", "rb"))
    orig_eval = par.evalue
    orig_cov = par.cov_mode
    t_index = os.path.abspath(tdb) + ".index"
    with open(t_index, "rb") as f:
        index_lines = f.readlines()
    total = len(index_lines)
    par.set("evalue", par.evalue * (float(q_size) / total))
    par.set("cov_mode", {1: 2, 2: 1}.get(orig_cov, orig_cov))
    ungapped = par.alignment_mode == 4  # ALIGNMENT_MODE_UNGAPPED

    profdb = wf.path("profileDB")
    tdb_abs = os.path.abspath(tdb)
    for suf in ("", ".dbtype"):
        if os.path.lexists(profdb + suf):
            os.unlink(profdb + suf)
        os.symlink(tdb_abs + suf, profdb + suf)

    avail_disk = _parse_mem_limit(par.disk_space_limit)
    # prefilter result line budget (searchslicedtargetprofile.sh RESSIZE)
    RESSIZE = 25
    saturate = max(1, q_size)
    first = 0
    prev_results = 0
    aln_merged = wf.path("aln_merged")
    aln = wf.path("aln")
    pref = wf.path("pref")
    while first < total:
        if prev_results > 0:
            saturate = max(1, prev_results // first)
        if avail_disk:
            budget = avail_disk
        else:
            budget = shutil.disk_usage(wf.tmp).free // 2
        n_in_step = max(1, budget // saturate // RESSIZE)
        last = min(total, first + n_in_step)
        with open(profdb + ".index", "wb") as f:
            f.writelines(index_lines[first:last])

        orig_max = par.max_seqs
        par.set("max_seqs", max(300, q_size))
        wf.step_always("prefilter", [profdb, qdb, pref], par)
        par.set("max_seqs", orig_max)

        pr = DBReader(pref)
        prev_results += sum(pr.get_data(i).count(b"\n")
                            for i in range(pr.size))
        pr.close()
        first = last

        if ungapped:
            orig_rm = par.rescore_mode
            par.set("rescore_mode", 2)
            wf.step_always("rescorediagonal", [profdb, qdb, pref, aln], par)
            par.set("rescore_mode", orig_rm)
        else:
            orig_om = par.alignment_output_mode
            par.set("alignment_output_mode", 1)
            wf.step_always("align", [profdb, qdb, pref, aln], par)
            par.set("alignment_output_mode", orig_om)
        _rmdb(pref)

        if par.exhaustive_search_filter == 1:
            filt = wf.path("aln_filt")
            wf.step_always("filterresult", [profdb, qdb, aln, filt], par)
            _rmdb(aln)
            _mvdb(filt, aln)

        if os.path.exists(aln_merged + ".dbtype"):
            merged_new = wf.path("aln_merged_new")
            wf.step_always("mergedbs", [tdb, merged_new, aln_merged, aln],
                           par)
            _rmdb(aln_merged)
            _mvdb(merged_new, aln_merged)
            _rmdb(aln)
        else:
            _mvdb(aln, aln_merged)

    aln_final = wf.path("aln_final")
    if ungapped:
        orig_rm = par.rescore_mode
        par.set("rescore_mode", 2)
        wf.step(aln_final, "rescorediagonal",
                [tdb, qdb, aln_merged, aln_final], par)
        par.set("rescore_mode", orig_rm)
    else:
        wf.step(aln_final, "align", [tdb, qdb, aln_merged, aln_final], par)
    # swapresults must not re-filter by evalue (Search.cpp:381-383)
    par.set("evalue", 1.7976931348623157e308)
    wf.step(out_aln, "swapresults", [tdb, qdb, aln_final, out_aln], par)
    par.set("evalue", orig_eval)
    par.set("cov_mode", orig_cov)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _rmdb(path):
    for suf in ("", ".index", ".dbtype"):
        if os.path.exists(path + suf):
            os.remove(path + suf)


def _mvdb(src, dst):
    for suf in ("", ".index", ".dbtype"):
        if os.path.exists(src + suf):
            os.replace(src + suf, dst + suf)


def _search_target_profile(par, wf, qdb, tdb, out_aln):
    """Sequence queries vs profile targets (searchtargetprofile.sh)."""
    INT_MAX = 2147483647
    pref = wf.path("pref")
    wf.step(pref, "prefilter", [qdb, tdb, pref], par)
    wf.step(wf.path("pref_swapped"), "swapresults",
            [qdb, tdb, pref, wf.path("pref_swapped")], par)
    # align all swapped hits; coverage mode swaps with the direction
    orig_cov = par.cov_mode
    par.set("cov_mode", {1: 2, 2: 1}.get(orig_cov, orig_cov))
    wf.step(wf.path("aln_swapped"), "align",
            [tdb, qdb, wf.path("pref_swapped"), wf.path("aln_swapped"),
             "--max-seqs", str(INT_MAX)], par)
    par.set("cov_mode", orig_cov)
    wf.step(out_aln, "swapresults",
            [tdb, qdb, wf.path("aln_swapped"), out_aln], par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def enrich(par, command):
    """`enrich` — iterative profile-enrichment search through a profile DB.

    Reference: data/workflow/enrich.sh + src/workflow/Enrich.cpp:11-14
    (defaults numIterations=3, expansionMode=1, backtrace on). Pipeline:
    exhaustive search of the query against the target-profile DB, convert
    to query profiles, then NUM_IT rounds of [prefilter vs the profile
    consensus DB -> subtract already-found -> align -> expandaln through
    the profile members -> merge -> next-round profiles].
    """
    qdb, prof_seq, target_prof, prof_res, out_db, tmp = par.filenames[:6]
    if not par.was_set("num_iterations"):
        par.set("num_iterations", 3)
    if not par.was_set("expansion_mode"):
        par.set("expansion_mode", 1)
    par.set("add_backtrace", True)
    wf = Workflow(tmp, par.force_reuse)
    num_it = par.num_iterations
    original_eval = par.evalue
    eval_profile = min(par.evalue, par.e_profile)
    consensus = target_prof + "_consensus"
    if not os.path.exists(consensus + ".dbtype"):
        # profile DBs from result2profile ship without a consensus DB;
        # materialize one (the reference assumes createdb-style profile DBs
        # that already carry _consensus)
        consensus = wf.path("prof_consensus")
        wf.step(consensus, "profile2consensus", [target_prof, consensus],
                par)

    search_slice = wf.path("search_slice")
    wf.step(search_slice, "search",
            [qdb, target_prof, search_slice, wf.path("slice_tmp"),
             "--num-iterations", 1, "-a", 1], par)
    prof_slice = wf.path("prof_slice")
    wf.step(prof_slice, "result2profile",
            [qdb, target_prof, search_slice, prof_slice], par)

    current_q = prof_slice
    aln0 = wf.path("aln_0")
    for step in range(num_it):
        last = step == num_it - 1
        step_eval = original_eval if last else eval_profile
        pref = wf.path(f"pref_{step}")
        wf.step(pref, "prefilter", [current_q, consensus, pref], par)
        if step >= 1:
            marker = pref + ".hasnext"
            if not os.path.exists(marker):
                sub = wf.path(f"pref_next_{step}")
                wf.step_always("subtractdbs",
                               [pref, aln0, sub, "-e", original_eval,
                                "--e-profile", par.e_profile], par)
                for suf in ("", ".index", ".dbtype"):
                    os.replace(sub + suf, pref + suf)
                open(marker, "w").close()
        aln = wf.path(f"aln_{step}")
        wf.step(aln, "align",
                [current_q, consensus, pref, aln, "-e", step_eval,
                 "-a", 1], par)
        exp_marker = wf.path(f"aln_exp_{step}.hasexpand")
        if not os.path.exists(exp_marker):
            exp = wf.path(f"aln_exp_{step}")
            wf.step_always("expandaln",
                           [current_q, prof_seq, aln, prof_res, exp,
                            "--expansion-mode", par.expansion_mode], par)
            for suf in ("", ".index", ".dbtype"):
                os.replace(exp + suf, aln + suf)
            open(exp_marker, "w").close()
        if step > 0:
            merge_marker = aln + ".hasmerge"
            if not os.path.exists(merge_marker):
                new = wf.path("aln_new")
                wf.step_always("mergedbs", [current_q, new, aln0, aln], par)
                for suf in ("", ".index", ".dbtype"):
                    os.replace(new + suf, aln0 + suf)
                open(merge_marker, "w").close()
        if step != num_it - 1:
            prof = wf.path(f"profile_{step}")
            wf.step(prof, "result2profile", [qdb, prof_seq, aln0, prof],
                    par)
            current_q = prof
    for suf in ("", ".index", ".dbtype"):
        if os.path.exists(aln0 + suf):
            os.replace(aln0 + suf, out_db + suf)
    wf.cleanup(par.remove_tmp_files)
    return 0
