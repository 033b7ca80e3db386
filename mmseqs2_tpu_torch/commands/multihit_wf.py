"""multihitdb / multihitsearch workflows.

Reference: src/multihit/MultiHitDb.cpp + data/workflow/multihitdb.sh
(nucleotide contigs -> per-contig sets of translated ORFs with the
companion set DBs), src/multihit/MultiHitSearch.cpp +
data/workflow/multihitsearch.sh (search + besthitperset +
mergeresultsbyset [+ combinepvalperset]).

Port of mmseqs2_tpu/commands/multihit_wf.py: multihitsearch's search runs
the k-mer prefilter (diag_rescore) and align (sw_multi) on the card.
"""

import os

from ..db import dbtype as dbt
from ..utils import log
from ..workflow.engine import Workflow, not_exists


def _move_db(src, dst):
    for suf in ("", ".index", ".dbtype", ".lookup", ".source", "_h",
                "_h.index", "_h.dbtype"):
        if os.path.exists(src + suf):
            os.replace(src + suf, dst + suf)


def multihitdb(par, command):
    """Build a set DB from nucleotide contig FASTA(s)."""
    paths = par.filenames
    tmp_dir = paths[-1]
    out_db = paths[-2]
    inputs = paths[:-2]
    wf = Workflow(tmp_dir)

    if not_exists(out_db + "_nucl") and not_exists(out_db):
        wf.step(out_db, "createdb", list(inputs) + [out_db], par)
    if not_exists(out_db + "_nucl"):
        with open(out_db + ".dbtype", "rb") as f:
            is_nucl = f.read(2)[0] == dbt.DBTYPE_NUCLEOTIDES
        if not is_nucl:
            log.die("protein mode not implemented")
        _move_db(out_db, out_db + "_nucl")
    nucl = out_db + "_nucl"

    c2s_tsv = out_db + "_nucl_contig_to_set.tsv"
    if not_exists(out_db + "_nucl_contig_to_set"):
        rows = []
        with open(nucl + ".lookup") as f:
            for line in f:
                p = line.rstrip("\n").split("\t")
                rows.append((int(p[0]), int(p[2])))
        rows.sort()
        with open(c2s_tsv, "w") as f:
            f.write("".join(f"{a}\t{b}\n" for a, b in rows))
        wf.step(out_db + "_nucl_contig_to_set", "tsv2db",
                [c2s_tsv, out_db + "_nucl_contig_to_set"], par)
    if not_exists(out_db + "_nucl_set_to_contig"):
        rows = []
        with open(nucl + ".lookup") as f:
            for line in f:
                p = line.rstrip("\n").split("\t")
                rows.append((int(p[2]), int(p[0])))
        rows.sort()
        s2c_tsv = out_db + "_nucl_set_to_contig.tsv"
        with open(s2c_tsv, "w") as f:
            f.write("".join(f"{a}\t{b}\n" for a, b in rows))
        wf.step(out_db + "_nucl_set_to_contig", "tsv2db",
                [s2c_tsv, out_db + "_nucl_set_to_contig"], par)

    orf = out_db + "_nucl_orf"
    if not par.was_set("orf_min_length"):
        par.set("orf_min_length", 30)     # MultiHitDb.cpp:11
    wf.step(orf, "extractorfs", [nucl, orf], par)
    wf.step(out_db, "translatenucs", [orf, out_db], par)
    wf.step(out_db + "_nucl_orf_aligned_to_contig", "orftocontig",
            [nucl, orf, out_db + "_nucl_orf_aligned_to_contig"], par)
    wf.step(out_db + "_nucl_orf_to_contig", "filterdb",
            [out_db + "_nucl_orf_aligned_to_contig",
             out_db + "_nucl_orf_to_contig", "--trim-to-one-column",
             "--filter-regex", "^.*$"], par)
    wf.step(out_db + "_member_to_set", "filterdb",
            [out_db + "_nucl_orf_to_contig", out_db + "_member_to_set",
             "--mapping-file", c2s_tsv], par)
    wf.step(out_db + "_set_to_member", "swapdb",
            [out_db + "_member_to_set", out_db + "_set_to_member"], par)
    wf.step(out_db + "_set_size", "result2stats",
            [nucl, nucl, out_db + "_set_to_member", out_db + "_set_size",
             "--stat", "linecount"], par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def multihitsearch(par, command):
    """Set-vs-set search (multihitsearch.sh)."""
    query, target, output, tmp_dir = par.filenames[:4]
    wf = Workflow(tmp_dir)
    result = wf.path("result")
    aggregate = wf.path("aggregate")
    wf.step(result, "search",
            [query, target, result, wf.path("search")], par)
    wf.step(aggregate, "besthitperset",
            [query, target, result, aggregate], par)
    wf.step(output, "mergeresultsbyset",
            [query + "_set_to_member", aggregate, output], par)
    wf.cleanup(par.remove_tmp_files)
    return 0
