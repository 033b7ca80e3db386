"""map / rbh workflows (+ easy variants) and the result2rbh module.

Reference: src/workflow/Map.cpp:10-23 (high-identity mapping defaults over
the plain search workflow, data/workflow/map.sh), src/workflow/Rbh.cpp +
data/workflow/rbh.sh (A->B and B->A searches, best-bitscore band merge,
reciprocal extraction via result2rbh, src/util/result2rbh.cpp:10-77).

Port of mmseqs2_tpu/commands/map_rbh.py: rbh's two searches run the k-mer
prefilter (diag_rescore) and align (sw_multi) on the card; map's search
runs the prefilter, then rescorediagonal (--alignment-mode 4) on the host.
"""

import os

from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..workflow.engine import Workflow
from .common import fast_atoi


def _set_default(par, attr, value):
    if not par.was_set(attr):
        par.set(attr, value)


def map_workflow(par, command):
    """Map: fast ~exact matching (Map.cpp setMapWorkflowDefaults)."""
    _set_default(par, "comp_bias_corr", 0)
    _set_default(par, "mask", 0)
    _set_default(par, "cov_thr", 0.95)
    _set_default(par, "cov_mode", 2)
    _set_default(par, "min_seq_id", 0.9)
    _set_default(par, "sensitivity", 2.0)
    _set_default(par, "rescore_mode", 2)      # RESCORE_MODE_ALIGNMENT
    _set_default(par, "alignment_mode", 4)    # -> rescorediagonal path
    _set_default(par, "sort_results", 1)
    _set_default(par, "orf_start_mode", 1)
    _set_default(par, "orf_min_length", 10)
    _set_default(par, "orf_max_length", 32734)
    query, target, out, tmp_dir = par.filenames[:4]
    wf = Workflow(tmp_dir)
    wf.step(out, "search", [query, target, out, tmp_dir], par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def result2rbh(par, command):
    """Reciprocal-best-hit extraction (result2rbh.cpp): per A entry the
    first line is A's best B hit; subsequent lines with the SAME bit score
    are the swapped B-best-A records -> reciprocal hits."""
    in_path, out_path = par.filenames[:2]
    reader = DBReader(in_path)
    writer = DBWriter(out_path, reader.base_type, reader.extended_type)
    for i in range(reader.size):
        best = 0
        out = []
        for line in reader.get_data(i).split(b"\n"):
            if not line:
                continue
            score = fast_atoi(line.split(b"\t")[1])
            if best == 0:
                best = score
            else:
                if score != best:
                    break
                out.append(line)
        writer.write(reader.get_db_key(i),
                     b"".join(x + b"\n" for x in out))
    writer.close()
    reader.close()
    return 0


def _swap_cov_mode(mode):
    """Util::swapCoverageMode: query<->target coverage for the reverse
    search direction."""
    return {1: 2, 2: 1}.get(mode, mode)


def rbh(par, command):
    """Reciprocal best hit workflow (rbh.sh, Rbh.cpp setRbhDefaults)."""
    # rbh does NOT apply setSearchDefaults: its searches run at the GLOBAL
    # default sensitivity 4.0 (Parameters.cpp:2498), not search's 5.7
    _set_default(par, "sensitivity", 4.0)
    _set_default(par, "comp_bias_corr", 0)
    _set_default(par, "alignment_mode", 3)    # SCORE_COV_SEQID
    _set_default(par, "mask", 0)
    _set_default(par, "orf_start_mode", 1)
    _set_default(par, "orf_min_length", 10)
    _set_default(par, "orf_max_length", 32734)
    a_db, b_db, out, tmp_dir = par.filenames[:4]
    wf = Workflow(tmp_dir)
    res_ab = wf.path("resAB")
    res_ba = wf.path("resBA")
    wf.step(res_ab, "search", [a_db, b_db, res_ab, wf.path("tempAB")], par)
    orig_cov_mode = par.cov_mode
    par.set("cov_mode", _swap_cov_mode(par.cov_mode))
    wf.step(res_ba, "search", [b_db, a_db, res_ba, wf.path("tempBA")], par)
    par.set("cov_mode", orig_cov_mode)
    wf.step(wf.path("resA_best_B"), "filterdb",
            [res_ab, wf.path("resA_best_B"), "--extract-lines", "1"])
    wf.step(wf.path("resB_best_A"), "filterdb",
            [res_ba, wf.path("resB_best_A"), "--beats-first",
             "--filter-column", "2", "--comparison-operator", "e"])
    wf.step(wf.path("resB_best_A_swap"), "swapresults",
            [b_db, a_db, wf.path("resB_best_A"),
             wf.path("resB_best_A_swap"), "-e", "100000000"])
    wf.step(wf.path("res_best_merged"), "mergedbs",
            [wf.path("resA_best_B"), wf.path("res_best_merged"),
             wf.path("resA_best_B"), wf.path("resB_best_A_swap")])
    wf.step(wf.path("res_best_merged_sorted"), "filterdb",
            [wf.path("res_best_merged"), wf.path("res_best_merged_sorted"),
             "--sort-entries", "2", "--filter-column", "2"])
    wf.step(out, "result2rbh",
            [wf.path("res_best_merged_sorted"), out])
    wf.cleanup(par.remove_tmp_files)
    return 0


def _easy_db(wf, par, path, db):
    """createdb unless the input is already a DB."""
    if os.path.exists(path + ".dbtype"):
        return path
    wf.step(db, "createdb", [path, db], par)
    return db


def easy_rbh(par, command):
    """easy-rbh: FASTA in, BLAST-tab out (src/workflow/EasyRbh.cpp)."""
    a_fa, b_fa, out_file, tmp_dir = par.filenames[:4]
    wf = Workflow(tmp_dir)
    qdb = _easy_db(wf, par, a_fa, wf.path("query"))
    tdb = _easy_db(wf, par, b_fa, wf.path("target"))
    res = wf.path("result")
    par.filenames = [qdb, tdb, res, wf.path("rbh_tmp")]
    rbh(par, command)
    from .convertalis import convertalis as conv
    from ..params import Params
    from ..registry import get_command
    cmd = get_command("convertalis")
    sub = Params().parse([qdb, tdb, res, out_file], cmd, 4, 4)
    for attr in par._was_set:
        if attr not in sub._was_set:
            sub.set(attr, getattr(par, attr))
    conv(sub, cmd)
    wf.cleanup(par.remove_tmp_files)
    return 0
