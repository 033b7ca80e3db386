"""Taxonomy commands: createtaxdb (offline), lca, majoritylca, addtaxonomy,
taxonomyreport, filtertaxdb, filtertaxseqdb, aggregatetax(weights),
createbintaxmapping, createbintaxonomy, createdmptaxonomy, nrtotaxmapping
+ the taxonomy and easy-taxonomy workflows.

Port of mmseqs2_tpu/commands/tax_tools.py (host code; the workflow's search
runs the prefilter and lcaalign on the card). Reference:
src/taxonomy/*.cpp and data/workflow/{createtaxdb,taxonomy}.sh.
"""

import math
import os
import shutil

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..taxonomy.ncbi import (MAX_TAX_WEIGHT, MappingReader, NcbiTaxonomy,
                             TaxonomyExpression, parse_ranks)
from ..utils import log
from .common import fast_atoi

FLT_MAX = np.finfo(np.float32).max


def createtaxdb(par, command):
    """Offline creation only (zero-egress environment): requires
    --ncbi-tax-dump <dir> and --tax-mapping-file <accession2taxid>.

    --tax-db-mode 1 (default, createtaxdb.sh:78-81): serialize the dumps
    into the binary <db>_taxonomy; 0: copy the dmp files next to the seqDB.
    --tax-mapping-mode 0 (createtaxdb.sh:104-106): join accession->taxid
    with <db>.lookup; 1 (:107-109): the mapping file maps SOURCE names to
    taxids, every sequence inherits its source's taxid."""
    db, tmp = par.filenames[:2]
    if not par.ncbi_tax_dump:
        log.die("Automatic taxdump download is not available in this "
                "environment. Provide --ncbi-tax-dump <dir> with "
                "names.dmp/nodes.dmp/merged.dmp/delnodes.dmp")
    if not par.tax_mapping_file:
        log.die("Automatic mapping download is not available. Provide "
                "--tax-mapping-file <accession\\ttaxid file>")
    dump = par.ncbi_tax_dump
    if par.tax_db_mode == 1:
        from ..taxonomy.ncbi import serialize_taxonomy
        with open(db + "_taxonomy", "wb") as f:
            f.write(serialize_taxonomy(
                os.path.join(dump, "names.dmp"),
                os.path.join(dump, "nodes.dmp"),
                os.path.join(dump, "merged.dmp")))
    else:
        for f in ("names.dmp", "nodes.dmp", "merged.dmp", "delnodes.dmp"):
            src = os.path.join(dump, f)
            if os.path.exists(src):
                shutil.copyfile(src, f"{db}_{f}")
    name2tax = {}
    with open(par.tax_mapping_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                name2tax[parts[0]] = parts[1]
    if par.tax_mapping_mode == 0:
        # key -> accession -> taxid
        with open(db + ".lookup") as f, open(db + "_mapping", "w") as out:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2 and parts[1] in name2tax:
                    out.write(f"{parts[0]}\t{name2tax[parts[1]]}\n")
    else:
        # source id -> source name -> taxid; key -> source id
        src2tax = {}
        with open(db + ".source") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    src2tax[parts[0]] = name2tax.get(parts[1], "")
        with open(db + ".lookup") as f, open(db + "_mapping", "w") as out:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 3:
                    out.write(f"{parts[0]}\t{src2tax.get(parts[2], '')}\n")
    return 0


def createbintaxmapping(par, command):
    """Kept as a sorted text mapping (we read text mappings directly)."""
    in_path, out_path = par.filenames[:2]
    pairs = []
    with open(in_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((int(parts[0]), int(parts[1])))
    pairs.sort()
    with open(out_path, "w") as f:
        for k, t in pairs:
            f.write(f"{k}\t{t}\n")
    return 0


def _weight_of(evalue: float, vote_mode: int) -> float:
    # WeightedTaxHit ctor (NcbiTaxonomy.cpp:598-620); the evalue arrives as
    # FLOAT, so tiny E-values underflow to 0 and get MAX_TAX_WEIGHT
    if vote_mode == 0:
        return 1.0
    ev32 = np.float32(evalue)
    if vote_mode == 1:
        if ev32 == FLT_MAX:
            return float(ev32)
        if ev32 > 0:
            return -math.log(float(ev32))
        return MAX_TAX_WEIGHT
    return float(ev32)              # AGG_TAX_SCORE


def _do_lca(par, majority: bool):
    tax_db, res_path, out_path = par.filenames[:3]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    mapping = MappingReader(tax_db)
    reader = DBReader(res_path)
    vote_mode = par.vote_mode
    if majority:
        if vote_mode != 0 and reader.base_type == dbt.DBTYPE_CLUSTER_RES:
            log.warning("Cluster input can only be used with --vote-mode 0\n"
                        "Continuing with --vote-mode 0")
            vote_mode = 0
        elif vote_mode == 1 and reader.base_type in (
                dbt.DBTYPE_PREFILTER_RES, dbt.DBTYPE_PREFILTER_REV_RES):
            log.warning("Prefilter input can only be used with --vote-mode "
                        "0 or 2\nContinuing with --vote-mode 0")
            vote_mode = 0

    ranks = parse_ranks(par.lca_ranks)
    blacklist = []
    for tok in par.blacklist.split(","):
        if not tok:
            continue
        taxon = fast_atoi(tok.split(":")[0].encode())
        if taxon == 0:
            log.warning("Cannot block root taxon 0")
            continue
        if not t.node_exists(taxon):
            log.warning(f"Ignoring missing blocked taxon {taxon}")
            continue
        blacklist.append(taxon)

    no_tax = "0\tno rank\tunclassified"
    if ranks:
        no_tax += "\t"
    if par.tax_lineage > 0:
        no_tax += "\t"
    no_tax += "\n"

    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, dbt.DBTYPE_TAXONOMICAL_RESULT) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            data = reader.get_data(int(i))
            taxa = []
            weighted = []
            for line in data.split(b"\n"):
                if not line:
                    continue
                cols = line.split(b"\t")
                tid = fast_atoi(cols[0])
                taxon = mapping.lookup(tid)
                if taxon == 0:
                    continue
                if any(t.is_ancestor(b, taxon) for b in blacklist):
                    continue
                if majority:
                    weight = float(FLT_MAX)
                    if vote_mode == 1:
                        if len(cols) <= 3:
                            log.die(f"No alignment result for taxon "
                                    f"{taxon} found")
                        weight = float(cols[3])
                    elif vote_mode == 2:
                        if len(cols) <= 1:
                            log.die(f"No alignment result for taxon "
                                    f"{taxon} found")
                        weight = float(cols[1])
                    weighted.append((taxon, _weight_of(weight, vote_mode)))
                else:
                    taxa.append(taxon)
            if len(data) == 0:
                w.write(key, no_tax.encode())
                continue
            if majority:
                sel, _, _, _, _ = t.weighted_majority_lca(weighted,
                                                          par.majority_thr)
                node = t.taxon_node(sel)
            else:
                node = t.lca(taxa)
            if node is None:
                w.write(key, no_tax.encode())
                continue
            out = f"{node.tax_id}\t{node.rank}\t{node.name}"
            if ranks:
                out += "\t" + ";".join(t.at_ranks(node, ranks))
            if par.tax_lineage == 1:
                out += "\t" + t.tax_lineage(node, True)
            elif par.tax_lineage == 2:
                out += "\t" + t.tax_lineage(node, False)
            w.write(key, (out + "\n").encode())
    return 0


def lca(par, command):
    return _do_lca(par, False)


def majoritylca(par, command):
    return _do_lca(par, True)


def addtaxonomy(par, command):
    """Append taxonomy columns to every result line (addtaxonomy.cpp)."""
    tax_db, res_path, out_path = par.filenames[:3]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    mapping = MappingReader(tax_db)
    reader = DBReader(res_path)
    is_taxres = reader.base_type == dbt.DBTYPE_TAXONOMICAL_RESULT
    ranks = parse_ranks(par.lca_ranks)
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            data = reader.get_data(int(i))
            if len(data) == 0:
                w.write(key, b"")
                continue
            taxon = 0
            if par.pick_id_from == 1:          # EXTRACT_QUERY
                taxon = mapping.lookup(key)
                if taxon == 0:
                    w.write(key, b"")
                    continue
            out = []
            for line in data.split(b"\n"):
                if not line:
                    continue
                if par.pick_id_from == 2:      # EXTRACT_TARGET
                    tid = fast_atoi(line.split(b"\t")[0])
                    taxon = (tid if is_taxres else mapping.lookup(tid))
                    if taxon == 0:
                        continue
                node = t.taxon_node(taxon)
                if node is None:
                    continue
                s = (line.decode() + f"\t{node.tax_id}\t{node.rank}\t"
                     f"{node.name}")
                if ranks:
                    s += "\t" + ";".join(t.at_ranks(node, ranks))
                if par.tax_lineage == 1:
                    s += "\t" + t.tax_lineage(node, True)
                elif par.tax_lineage == 2:
                    s += "\t" + t.tax_lineage(node, False)
                out.append(s + "\n")
            w.write(key, "".join(out).encode())
    return 0


def filtertaxdb(par, command):
    """Keep result lines whose target taxon matches --taxon-list."""
    tax_db, res_path, out_path = par.filenames[:3]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    mapping = MappingReader(tax_db)
    reader = DBReader(res_path)
    is_taxres = reader.base_type == dbt.DBTYPE_TAXONOMICAL_RESULT
    expr = TaxonomyExpression(par.taxon_list, t)
    order = np.argsort(reader.offsets, kind="stable")
    with DBWriter(out_path, reader.base_type, reader.extended_type) as w:
        for i in order:
            key = reader.get_db_key(int(i))
            out = []
            for line in reader.get_data(int(i)).split(b"\n"):
                if not line:
                    continue
                tid = fast_atoi(line.split(b"\t")[0])
                taxon = tid if is_taxres else mapping.lookup(tid)
                if expr.is_ancestor(taxon):
                    out.append(line + b"\n")
            w.write(key, b"".join(out))
    return 0


def taxonomyreport(par, command):
    """Kraken-style clade report (taxonomyreport.cpp, report mode 0)."""
    if par.report_mode != 0:
        log.die("Only --report-mode 0 (Kraken style) is implemented")
    tax_db, res_path, out_path = par.filenames[:3]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    reader = DBReader(res_path)
    is_seq_db = reader.base_type in (dbt.DBTYPE_AMINO_ACIDS,
                                     dbt.DBTYPE_NUCLEOTIDES,
                                     dbt.DBTYPE_HMM_PROFILE)
    is_taxres = reader.base_type == dbt.DBTYPE_TAXONOMICAL_RESULT
    mapping = None if is_taxres else MappingReader(tax_db)

    tax_counts = {}
    total = 0
    for i in range(reader.size):
        if is_seq_db:
            taxon = mapping.lookup(reader.get_db_key(i))
            tax_counts[taxon] = tax_counts.get(taxon, 0) + 1
            total += 1
            continue
        data = reader.get_data(i)
        for line in data.split(b"\n"):
            if not line:
                continue
            tid = fast_atoi(line.split(b"\t")[0])
            taxon = tid if is_taxres else mapping.lookup(tid)
            tax_counts[taxon] = tax_counts.get(taxon, 0) + 1
            total += 1

    clade = t.get_clade_counts({k: v for k, v in tax_counts.items()})

    lines = []

    def report(tax_id, depth):
        e = clade.get(tax_id)
        clade_count = e[0] if e else 0
        tax_count = e[1] if e else 0
        if tax_id == 0:
            if clade_count > 0:
                lines.append("%.4f\t%i\t%i\tno rank\t0\tunclassified\n"
                             % (100 * clade_count / float(total),
                                clade_count, tax_count))
            report(1, 0)
            return
        if clade_count == 0:
            return
        node = t.taxon_node(tax_id)
        indent = "  " * depth
        lines.append("%.4f\t%i\t%i\t%s\t%i\t%s%s\n"
                     % (100 * clade_count / float(total), clade_count,
                        tax_count, node.rank, tax_id, indent, node.name))
        children = sorted(e[2], key=lambda c: -(clade.get(c, [0])[0]))
        for c in children:
            if c in clade:
                report(c, depth + 1)
            else:
                break

    report(0, 0)
    with open(out_path, "w") as f:
        f.write("".join(lines))
    return 0


def taxonomy(par, command):
    """Taxonomy assignment workflow (data/workflow/taxonomy.sh +
    src/workflow/Taxonomy.cpp): search, optionally reduce to top hits, and
    compute the (approximate 2bLCA) LCA per query."""
    from ..workflow import Workflow

    qdb, tdb, out, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)

    # setTaxonomyDefaults
    for attr, val in (("sensitivity", 2.0), ("evalue", 1.0),
                      ("max_accept", 30), ("max_rejected", 5),
                      ("alignment_mode", 1), ("orf_start_mode", 1)):
        if not par.was_set(attr):
            par.set(attr, val)

    mode = par.lca_mode
    if mode == 2:
        log.warning("2bLCA was replaced by approximate 2bLCA")
        mode = 3

    from ..db import dbtype as dbt
    from ..db.reader import DBReader
    q_type = DBReader(qdb).base_type
    t_type = DBReader(tdb).base_type
    if q_type == dbt.DBTYPE_NUCLEOTIDES and t_type == dbt.DBTYPE_NUCLEOTIDES:
        if mode == 3:
            log.warning("Accel. 2bLCA cannot be used with nucl-nucl "
                        "taxonomy, using top-hit instead")
            mode = 4
    elif q_type == dbt.DBTYPE_NUCLEOTIDES:
        # nucleotide contigs vs protein targets: ORF-aggregated taxonomy
        # (Taxonomy.cpp:103-137 -> data/workflow/taxpercontig.sh)
        return _tax_per_contig(par, wf, qdb, tdb, out)

    search_args = [qdb, tdb, wf.path("first"), wf.path("tmp_hsp1"),
                   "-s", par.sensitivity, "-e", par.evalue,
                   "--max-accept", par.max_accept,
                   "--max-rejected", par.max_rejected,
                   "--alignment-mode", par.alignment_mode]
    if mode == 3:
        search_args += ["--lca-search", "1"]
    wf.step(wf.path("first"), "search", search_args, par)

    lca_in = wf.path("first")
    if mode == 4:
        top1 = wf.path("top1")
        wf.step(top1, "filterdb",
                [lca_in, top1, "--beats-first", "1", "--filter-column", "4",
                 "--comparison-operator", "le"], par)
        lca_in = top1

    if par.tax_output_mode in (0, 2):
        wf.step(out, "lca", [tdb, lca_in, out], par)
        if par.tax_output_mode == 2:
            import shutil
            for suf in ("", ".index", ".dbtype"):
                shutil.copyfile(lca_in + suf, out + "_aln" + suf)
    else:
        import shutil
        for suf in ("", ".index", ".dbtype"):
            shutil.copyfile(lca_in + suf, out + suf)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def _tax_per_contig(par, wf, contigs, taxdb, out):
    """taxpercontig.sh: extractorfs --translate -> optional non-selective
    ORF prefilter (+recoverlongestorf) -> per-ORF taxonomy -> contig-level
    aggregatetaxweights / top-hit alignment merge.
    Reference data/workflow/taxpercontig.sh + src/workflow/Taxonomy.cpp:
    103-137 (ORF filter: --min-ungapped-score 3, -s orf-filter-s,
    --diag-score 0, --max-seqs 1; rescorediagonal -e orf-filter-e
    --rescore-mode 2; soft subdb)."""
    import shutil

    from ..db import dbtype as dbt

    orfs = wf.path("orfs_aa")
    orig_translate = par.translate
    par.set("translate", 1)
    wf.step(orfs, "extractorfs", [contigs, orfs], par)
    par.set("translate", orig_translate)

    if par.orf_filter and par.orf_filter_s <= par.sensitivity:
        pref = wf.path("orfs_pref")
        wf.step(pref, "prefilter",
                [orfs, taxdb, pref, "--min-ungapped-score", 3,
                 "-s", par.orf_filter_s, "--diag-score", 0,
                 "--max-seqs", 1], par)
        aln = wf.path("orfs_aln")
        wf.step(aln, "rescorediagonal",
                [orfs, taxdb, pref, aln, "-e", par.orf_filter_e,
                 "--rescore-mode", 2], par)
        lst = wf.path("orfs_aln.list")
        if not os.path.exists(lst):
            rec = wf.path("orfs_aln_recovered.list")
            wf.step_always("recoverlongestorf", [orfs, aln, rec], par)
            with open(lst, "w") as f:
                with open(rec) as g:
                    f.write(g.read())
                with open(aln + ".index") as g:
                    for line in g:
                        p = line.split("\t")
                        if int(p[2]) > 1:
                            f.write(p[0] + "\n")
        filt = wf.path("orfs_filter")
        wf.step(filt, "createsubdb",
                [lst, orfs, filt, "--subdb-mode", 1], par)
        # drop the auto-symlinked header db so the real subset is built
        # (taxpercontig.sh:60 rmdb orfs_filter_h)
        if os.path.islink(filt + "_h"):
            for suf in ("", ".index", ".dbtype"):
                if os.path.lexists(filt + "_h" + suf):
                    os.unlink(filt + "_h" + suf)
        wf.step(filt + "_h", "createsubdb",
                [lst, orfs + "_h", filt + "_h", "--subdb-mode", 1], par)
        orfs = filt

    tax = wf.path("orfs_tax")
    orig_lineage = par.tax_lineage
    orig_out_mode = par.tax_output_mode
    par.set("tax_lineage", 0)
    par.set("tax_output_mode", 2)
    wf.step(tax, "taxonomy", [orfs, taxdb, tax, wf.path("tmp_taxonomy")],
            par)
    par.set("tax_lineage", orig_lineage)
    par.set("tax_output_mode", orig_out_mode)

    from ..workflow.engine import not_exists
    swapped = wf.path("orfs_h_swapped")
    if not_exists(swapped):
        wf.step(swapped, "swapdb", [orfs + "_h", swapped], par)
        # the swapped header db is consumed as a result db
        # (taxpercontig.sh:82 forces dbtype 5)
        with open(swapped + ".dbtype", "wb") as f:
            f.write(bytes([dbt.DBTYPE_ALIGNMENT_RES, 0, 0, 0]))

    if par.tax_output_mode in (0, 2):
        wf.step(out, "aggregatetaxweights",
                [taxdb, swapped, tax, tax + "_aln", out], par)
    if par.tax_output_mode in (1, 2):
        first = wf.path("orfs_tax_aln_first")
        wf.step(first, "filterdb",
                [tax + "_aln", first, "--extract-lines", 1], par)
        out_aln = out if par.tax_output_mode == 1 else out + "_aln"
        wf.step(out_aln, "mergeresultsbyset", [swapped, first, out_aln],
                par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


def easy_taxonomy(par, command):
    """easy-taxonomy (data/workflow/easytaxonomy.sh +
    src/workflow/EasyTaxonomy.cpp): createdb + taxonomy (output mode BOTH) +
    lca TSV + Kraken report + per-target tophit report and alignment TSV."""
    from ..workflow import Workflow

    fasta, tdb, out_prefix, tmp = par.filenames[:4]
    wf = Workflow(tmp, par.force_reuse)
    # setEasyTaxonomyDefaults: file-order keys (soft split mode), no lookup
    if not par.was_set("createdb_mode"):
        par.set("createdb_mode", 1)
    if not par.was_set("write_lookup"):
        par.set("write_lookup", 0)
    qdb = wf.path("query")
    wf.step(qdb, "createdb", [fasta, qdb], par)

    # EasyTaxonomy.cpp:62-63 forces TAXONOMY_OUTPUT_BOTH
    par.set("tax_output_mode", 2)
    result = wf.path("result")
    wf.step(result, "taxonomy",
            [qdb, tdb, result, wf.path("taxonomy_tmp")], par)

    wf.step(out_prefix + "_lca.tsv", "createtsv",
            [qdb, result, out_prefix + "_lca.tsv"], par)
    wf.step(out_prefix + "_report", "taxonomyreport",
            [tdb, result, out_prefix + "_report"], par)

    # SWAPRESULT_PAR is built with evalThr = FLT_MAX (EasyTaxonomy.cpp:71)
    swapped = wf.path("result_aln_swapped")
    wf.step(swapped, "swapresults",
            [qdb, tdb, result + "_aln", swapped, "-e", "3.402823466e+38"],
            par)
    summed = wf.path("result_aln_swapped_sum")
    wf.step(summed, "summarizealis", [swapped, summed], par)
    # ADDTAXONOMY_PAR with pickIdFrom = 1 (EasyTaxonomy.cpp:73)
    sum_tax = wf.path("result_aln_swapped_sum_tax")
    wf.step(sum_tax, "addtaxonomy",
            [tdb, summed, sum_tax, "--pick-id-from", "1"], par)
    wf.step(out_prefix + "_tophit_report", "createtsv",
            [tdb, sum_tax, out_prefix + "_tophit_report"], par)
    wf.step(out_prefix + "_tophit_aln", "convertalis",
            [qdb, tdb, result + "_aln", out_prefix + "_tophit_aln"], par)
    if par.remove_tmp_files:
        wf.cleanup(True)
    return 0


# -- aggregatetax / aggregatetaxweights (src/taxonomy/aggregatetax.cpp) ---------


def _aggregate(par, use_aln: bool):
    """Aggregate per-sequence taxon assignments to per-set labels via
    weighted majority LCA (aggregatetax.cpp:15-191). Output columns:
    taxid, rank, name, totalSeqs, assignedSeqs, agreeingSeqs, percent
    [+ranks] [+lineage]."""
    tax_db = par.filenames[0]
    set_to_seq_path = par.filenames[1]
    tax_seq_path = par.filenames[2]
    if use_aln:
        aln_path, out_path = par.filenames[3], par.filenames[4]
        aln = DBReader(aln_path)
    else:
        aln, out_path = None, par.filenames[3]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    sets = DBReader(set_to_seq_path)
    tax_seq = DBReader(tax_seq_path)
    ranks = parse_ranks(par.lca_ranks)
    order = np.argsort(sets.offsets, kind="stable")
    with DBWriter(out_path, dbt.DBTYPE_TAXONOMICAL_RESULT,
                  compressed=bool(par.compressed)) as w:
        for i in order:
            set_key = sets.get_db_key(int(i))
            set_taxa = []
            for line in sets.get_data(int(i)).split(b"\n"):
                if not line:
                    continue
                seq_key = fast_atoi(line.split(b"\t")[0])
                sid = tax_seq.get_id(seq_key)
                if sid < 0:
                    log.die(f"Missing key {seq_key} in tax result")
                taxon = fast_atoi(tax_seq.get_data(sid))
                if use_aln and taxon != 0:
                    aid = aln.get_id(seq_key)
                    if aid < 0:
                        log.die(f"Missing key {seq_key} in alignment "
                                f"result")
                    cols = aln.get_data(aid).split(b"\n")[0].split(b"\t")
                    weight = float(FLT_MAX)
                    if par.vote_mode == 1:      # AGG_TAX_MINUS_LOG_EVAL
                        if len(cols) <= 3:
                            log.die(f"No alignment evalue for taxon "
                                    f"{taxon} found")
                        weight = float(cols[3])
                    elif par.vote_mode == 2:    # AGG_TAX_SCORE
                        if len(cols) <= 1:
                            log.die(f"No alignment score for taxon "
                                    f"{taxon} found")
                        weight = float(cols[1])
                    set_taxa.append((taxon, _weight_of(weight,
                                                       par.vote_mode)))
                else:
                    set_taxa.append((taxon, 1.0))
            sel, assigned, unassigned, agree, percent = \
                t.weighted_majority_lca(set_taxa, par.majority_thr)
            node = t.taxon_node(sel) if sel else None
            total = assigned + unassigned
            pct = math.floor(float(np.float32(percent)) * 100 + 0.5) / 100
            if sel == 0 or node is None:
                out = (f"0\tno rank\tunclassified\t{total}\t{assigned}"
                       f"\t{agree}\t{pct:.3f}")
                if ranks:
                    out += "\t"
                if par.tax_lineage > 0:
                    out += "\t"
            else:
                out = (f"{node.tax_id}\t{node.rank}\t{node.name}\t{total}"
                       f"\t{assigned}\t{agree}\t{pct:.3f}")
                if ranks:
                    out += "\t" + ";".join(t.at_ranks(node, ranks))
                if par.tax_lineage == 1:
                    out += "\t" + t.tax_lineage(node, True)
                elif par.tax_lineage == 2:
                    out += "\t" + t.tax_lineage(node, False)
            w.write(set_key, (out + "\n").encode())
    return 0


def aggregatetax(par, command):
    return _aggregate(par, False)


def aggregatetaxweights(par, command):
    return _aggregate(par, True)


def filtertaxseqdb(par, command):
    """Retain sequence-DB entries whose taxon satisfies --taxon-list
    (src/taxonomy/filtertaxseqdb.cpp:14-90); ancillary files are
    symlinked like DBReader::softlinkDb(SEQUENCE_ANCILLARY)."""
    from ..taxonomy.ncbi import TaxonomyExpression

    db, out = par.filenames[:2]
    t = NcbiTaxonomy.open_taxonomy(db)
    mapping = MappingReader(db)
    expr = TaxonomyExpression(par.taxon_list, t)
    reader = DBReader(db)
    with DBWriter(out, reader.base_type, reader.extended_type,
                  compressed=bool(par.compressed)) as w:
        for i in (int(x) for x in np.argsort(reader.offsets,
                                             kind="stable")):
            key = reader.get_db_key(i)
            if expr.is_ancestor(int(mapping.lookup(key))):
                w.write(key, reader.get_data(i))
    reader.close()
    for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source",
                "_mapping", "_names.dmp", "_nodes.dmp", "_merged.dmp",
                "_taxonomy"):
        src, dst = db + suf, out + suf
        if os.path.exists(src) and not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
    return 0


def createbintaxonomy(par, command):
    """Serialize names/nodes/merged dmp files into the binary taxonomy
    format (src/taxonomy/createbintaxonomy.cpp:6-20)."""
    from ..taxonomy.ncbi import serialize_taxonomy

    names, nodes, merged, out = par.filenames[:4]
    with open(out, "wb") as f:
        f.write(serialize_taxonomy(names, nodes, merged))
    return 0


def createdmptaxonomy(par, command):
    """Dump a taxonomy DB back to NCBI-style dmp files
    (src/taxonomy/createbintaxonomy.cpp:22-110)."""
    tax_db, out = par.filenames[:2]
    t = NcbiTaxonomy.open_taxonomy(tax_db)
    max_tax = max(max(t.nodes, default=0), max(t.alias, default=0))
    with open(out + "_nodes.dmp", "w") as nodes_fp, \
            open(out + "_names.dmp", "w") as names_fp, \
            open(out + "_merged.dmp", "w") as merged_fp:
        for i in range(max_tax + 1):
            if i in t.alias:
                merged_fp.write(f"{i}\t|\t{t.alias[i]}\t|\n")
                continue
            node = t.nodes.get(i)
            if node is None:
                continue
            nodes_fp.write(f"{node.tax_id}\t|\t{node.parent_tax_id}\t|"
                           f"\t{node.rank}\t|\t\n")
            names_fp.write(f"{node.tax_id}\t|\t{node.name}\t|\t\t|"
                           f"\tscientific name\t|\n")
    return 0


def nrtotaxmapping(par, command):
    """`nrtotaxmapping` — taxonomy mapping TSV for an NCBI NR-style DB
    (reference src/util/nrtotaxmapping.cpp). Inputs: N accession2taxid
    files (cols: accession, accession.version, taxid, gi), then the seq DB
    (whose taxonomy dump must already be attached), output TSV.
    Per \\x01-merged header: the accession (up to the first '.'/' ') is
    looked up in the accession mapping; misses fall back to the LAST
    space-preceded [species name] bracket matched against taxonomy names
    that are UNIQUE across all nodes; the entry's taxon is the LCA."""
    import gzip

    out_path = par.filenames[-1]
    seq_db = par.filenames[-2]
    acc_files = par.filenames[:-2]

    acc_map = {}
    dup_acc = set()
    for path in acc_files:
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4:
                    if parts and parts[0] == "accession":
                        continue
                    log.die(f"Invalid accession2taxid file {path}")
                if parts[0] == "accession":
                    continue
                acc_map[parts[0]] = int(parts[2])

    taxonomy = NcbiTaxonomy.open_taxonomy(seq_db)
    name_count = {}
    for node in taxonomy.nodes.values():
        name_count[node.name] = name_count.get(node.name, 0) + 1
    unique_names = {n.name: n.tax_id for n in taxonomy.nodes.values()
                    if name_count[n.name] == 1}

    hdr = DBReader(seq_db + "_h")
    mapping = []
    for i in range(hdr.size):
        key = hdr.get_db_key(i)
        taxa = []
        data = hdr.get_data(i).rstrip(b"\x00").decode(errors="replace")
        for sub in data.replace("\n", "\x01").split("\x01"):
            if not sub:
                continue
            # accession = prefix up to first '.' or ' '
            cut = len(sub)
            for j, ch in enumerate(sub):
                if ch in ". ":
                    cut = j
                    break
            acc = sub[:cut]
            tid = acc_map.get(acc, 0)
            if tid:
                taxa.append(tid)
                continue
            # last space-preceded bracket
            name = None
            pos = 0
            while True:
                b = sub.find(" [", pos)
                if b < 0:
                    break
                e = sub.find("]", b + 2)
                name = sub[b + 2:e] if e >= 0 else sub[b + 2:]
                pos = b + 2
            if name:
                tid = unique_names.get(name, 0)
                if tid:
                    taxa.append(tid)
        node = taxonomy.lca(taxa) if taxa else None
        if node is not None:
            mapping.append((key, node.tax_id))
    hdr.close()
    mapping.sort()
    with open(out_path, "w") as f:
        for key, tid in mapping:
            f.write(f"{key}\t{tid}\n")
    return 0
