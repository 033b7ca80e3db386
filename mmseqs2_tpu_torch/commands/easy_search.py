"""`easy-search`: FASTA in, BLAST-tab out (createdb -> search -> convertalis).

Reference: src/workflow/EasySearch.cpp (+ data/workflow/easysearch.sh):
sets --alignment-mode 3 (SCORE_COV_SEQID) so real sequence identities reach
the m8 output (EasySearch.cpp:18). --greedy-best-hits keeps each query's
greedy non-overlapping best hits (summarizeresult) before convertalis.
"""

import os

from ..workflow import Workflow


def is_database(path: str) -> bool:
    return os.path.exists(path + ".dbtype")


def easy_search(par, command):
    q_in, t_in, out_file, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)

    if not par.was_set("alignment_mode"):
        par.set("alignment_mode", 3)

    qdb = wf.path("query")
    if is_database(q_in):
        qdb = q_in
    else:
        wf.step(qdb, "createdb", [q_in, qdb], par)

    tdb = wf.path("target")
    if is_database(t_in):
        tdb = t_in
    else:
        wf.step(tdb, "createdb", [t_in, tdb], par)

    # --greedy-best-hits needs backtraces for summarizeresult
    # (EasySearch.cpp:78-84)
    if par.greedy_best_hits and not par.add_backtrace:
        par.set("add_backtrace", True)

    aln = wf.path("result")
    search_tmp = wf.path("search_tmp")
    wf.step(aln, "search", [qdb, tdb, aln, search_tmp], par)

    if par.greedy_best_hits:
        best = wf.path("result_best")
        wf.step(best, "summarizeresult", [aln, best], par)
        aln = best

    from ..registry import get_command
    from ..params import Params
    cmd = get_command("convertalis")
    sub = Params().parse([qdb, tdb, aln, out_file], cmd, 4, 4)
    for attr in par._was_set:
        if attr not in sub._was_set:
            sub.set(attr, getattr(par, attr))
    cmd.load()(sub, cmd)

    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0
