"""`search` workflow: prefilter -> align (blastp.sh equivalent).

Port of mmseqs2_tpu/commands/search.py: the protein-vs-protein path with
single and multi sensitivity stepping. Reference: src/workflow/Search.cpp
(mode matrix :33-123, parameter wiring :544-629) + data/workflow/blastp.sh.
--prefilter-mode: 0 k-mer index (default), 1 exhaustive ungapped, 2
exhaustive (all-vs-all fake prefilter), mirroring Parameters::PREF_MODE_*;
1 and 2 both run `ungappedprefilter`, as in the JAX package. The sliced,
target-profile, nucleotide, translated and iterative searches, --lca-search,
--alignment-mode 4 and --prefilter-mode 3 are not yet ported (see
ROADMAP.md) and raise.
"""

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..workflow import Workflow
from ..workflow.engine import not_exists

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

    q_type = DBReader(qdb).base_type
    t_type = DBReader(tdb).base_type

    # EasySearch/Search set SCORE_COV_SEQID; plain search defaults SCORE_COV
    if not par.was_set("alignment_mode") and not par.add_backtrace:
        par.set("alignment_mode", 2)

    if par.exhaustive_search:
        _not_ported("search --exhaustive-search (the sliced search)")
    if dbt.DBTYPE_HMM_PROFILE in (q_type, t_type):
        _not_ported("the profile search")
    if dbt.DBTYPE_NUCLEOTIDES in (q_type, t_type):
        _not_ported("the nucleotide and translated search")
    if par.num_iterations > 1:
        _not_ported("the iterative profile search (--num-iterations)")
    if par.prefilter_mode not in PREF_COMMANDS:
        _not_ported(f"search --prefilter-mode {par.prefilter_mode}")
    if par.lca_search:
        _not_ported("search --lca-search (lcaalign)")
    if par.alignment_mode == 4:
        _not_ported("search --alignment-mode 4 (rescorediagonal)")

    # search raises the default prefilter sensitivity (Search.cpp:24)
    if not par.was_set("sensitivity"):
        par.set("sensitivity", 5.7)

    wf = Workflow(tmp, par.force_reuse)
    sens_steps = par.sens_steps if par.was_set("start_sens") else 1
    target_sens = par.sensitivity
    start_sens = min(par.start_sens, target_sens)
    pref_cmd = PREF_COMMANDS[par.prefilter_mode]

    if sens_steps <= 1:
        pref = wf.path("pref_0")
        wf.step(pref, pref_cmd, [qdb, tdb, pref, "-s", target_sens], par)
        wf.step(out_aln, "align", [qdb, tdb, pref, out_aln], par)
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
