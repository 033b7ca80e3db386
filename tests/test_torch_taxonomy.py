"""The port's taxonomy (`taxonomy/ncbi.py`, `commands/tax_tools.py`,
`lcaalign`, `search --lca-search`, `prefilter --taxon-list`, the taxonomy
columns of `convertalis`) with the CPU requested. Tolerance: byte equality
throughout.

- Against the reference MMseqs2 goldens: `golden/aggtax` (aggregatetax,
  aggregatetaxweights, filtertaxseqdb, createdmptaxonomy,
  createbintaxonomy, the binary taxonomy's round trip, createtaxdb modes),
  `golden/nrmap` (nrtotaxmapping), `golden/tl/reftl` (prefilter
  --taxon-list 9602 -s 7.5) and `golden/tpc` (the contig route of
  `taxonomy`).
- Against the JAX package on the same inputs, where no golden exists: a
  seeded set of short protein families with a seven-rank synthetic NCBI
  taxonomy attached by the port's createtaxdb. Each package runs the
  `taxonomy` workflow once per search (align for --lca-mode 1 and 4,
  lcaalign for 3) and every --tax-output-mode on it, `easy-taxonomy`, the
  taxonomy tools on one result DB, `lcaalign` alone (one case breaks its
  lca pass at --max-rejected), `convertalis` with the taxonomy columns,
  createtaxdb, and `easy-search --greedy-best-hits` (the port's search,
  then the JAX package's summarizeresult and convertalis).
"""

import os
import pathlib
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import align_cmd, prefilter_kmer
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
AGG = GOLDEN / "aggtax"
PAIR = GOLDEN / "pairaln"
TL = GOLDEN / "tl"
SEED = 1414


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(ENV, "cpu")


def run(args):
    assert cli.main([str(a) for a in args]) == 0


def run_jax(args):
    from mmseqs2_tpu import cli as jcli
    assert jcli.main([str(a) for a in args]) == 0


def db_bytes(path):
    """A DB's data file and index, byte for byte."""
    return (pathlib.Path(path).read_bytes(),
            pathlib.Path(str(path) + ".index").read_bytes())


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


# -- the reference goldens ---------------------------------------------------


def test_aggregatetax(tmp_path, on_cpu):
    out = tmp_path / "agg"
    run(["aggregatetax", PAIR / "tdb", AGG / "sets", AGG / "taxseq", out])
    assert db_bytes(out) == db_bytes(AGG / "refagg")


def test_aggregatetaxweights(tmp_path, on_cpu):
    out = tmp_path / "aggw"
    run(["aggregatetaxweights", PAIR / "tdb", AGG / "sets", AGG / "taxseq",
         AGG / "alnseq", out, "--vote-mode", 1])
    assert db_bytes(out) == db_bytes(AGG / "refaggw")


def test_filtertaxseqdb(tmp_path, on_cpu):
    out = tmp_path / "filt"
    run(["filtertaxseqdb", PAIR / "tdb", out, "--taxon-list", "9602"])
    assert db_bytes(out) == db_bytes(AGG / "reffilt")


def test_createdmptaxonomy(tmp_path, on_cpu):
    out = tmp_path / "dmp"
    run(["createdmptaxonomy", PAIR / "tdb", out])
    for suf in ("_nodes.dmp", "_names.dmp", "_merged.dmp"):
        assert (pathlib.Path(str(out) + suf).read_text()
                == (AGG / ("refdmp" + suf)).read_text())


def _normalize_bintax(buf: bytes) -> bytes:
    """The reference leaves 4 padding bytes of each TaxonNode
    uninitialized: zero them on both sides."""
    from mmseqs2_tpu_torch.taxonomy.ncbi import _NODE_DTYPE
    n = struct.unpack_from("<Q", buf, 4)[0]
    b = bytearray(buf)
    arr = np.frombuffer(bytes(b), _NODE_DTYPE, n, 16).copy()
    arr["_pad"] = 0
    b[16:16 + n * 32] = arr.tobytes()
    return bytes(b)


def test_createbintaxonomy(tmp_path, on_cpu):
    out = tmp_path / "taxonomy"
    run(["createbintaxonomy", PAIR / "tdb_names.dmp",
         PAIR / "tdb_nodes.dmp", PAIR / "tdb_merged.dmp", out])
    assert (_normalize_bintax(out.read_bytes())
            == _normalize_bintax((AGG / "ref_taxonomy").read_bytes()))


def test_binary_taxonomy_roundtrip():
    """load_binary_taxonomy on the reference's file equals the dmp loader
    (nodes, aliases, names)."""
    from mmseqs2_tpu_torch.taxonomy.ncbi import (NcbiTaxonomy,
                                                 load_binary_taxonomy)
    bt = load_binary_taxonomy(str(AGG / "ref_taxonomy"))
    tt = NcbiTaxonomy(str(PAIR / "tdb_names.dmp"),
                      str(PAIR / "tdb_nodes.dmp"),
                      str(PAIR / "tdb_merged.dmp"))
    assert set(bt.nodes) == set(tt.nodes)
    for k in tt.nodes:
        assert bt.nodes[k].parent_tax_id == tt.nodes[k].parent_tax_id
        assert bt.nodes[k].name == tt.nodes[k].name
    assert bt.alias == tt.alias


def test_createtaxdb_source_mapping(tmp_path, on_cpu):
    """--tax-db-mode 1 (the binary <db>_taxonomy) and --tax-mapping-mode 1
    (every sequence inherits its source's taxid; createtaxdb.sh:66-110),
    offline from dmp files; without them it dies and downloads nothing."""
    from mmseqs2_tpu_torch.taxonomy.ncbi import NcbiTaxonomy
    db = tmp_path / "db"
    for suf in ("", ".index", ".dbtype", ".lookup", ".source",
                "_h", "_h.index", "_h.dbtype"):
        shutil.copyfile(str(GOLDEN / "toy" / "qdb") + suf, str(db) + suf)
    dump = tmp_path / "dmp"
    dump.mkdir()
    for f in ("names.dmp", "nodes.dmp", "merged.dmp"):
        shutil.copyfile(AGG / f"refdmp_{f}", dump / f)
    (dump / "delnodes.dmp").write_text("")
    smap = tmp_path / "smap.tsv"
    smap.write_text("".join(
        f"{line.split(chr(9))[1]}\t9600\n"
        for line in (tmp_path / "db.source").read_text().splitlines()))
    with pytest.raises(SystemExit):
        cli.main(["createtaxdb", str(db), str(tmp_path / "tmp")])
    run(["createtaxdb", db, tmp_path / "tmp", "--ncbi-tax-dump", dump,
         "--tax-mapping-file", smap, "--tax-mapping-mode", 1])
    assert (tmp_path / "db_taxonomy").exists()
    mapping = (tmp_path / "db_mapping").read_text().splitlines()
    assert len(mapping) == 500
    assert all(line.split("\t")[1] == "9600" for line in mapping)
    assert NcbiTaxonomy.open_taxonomy(str(db)) is not None


def test_nrtotaxmapping(tmp_path, on_cpu):
    for f in (GOLDEN / "nrmap").iterdir():
        shutil.copy(f, tmp_path / f.name)
    out = tmp_path / "map.tsv"
    run(["nrtotaxmapping", tmp_path / "acc2taxid", tmp_path / "nrdb", out,
         "--threads", 1])
    assert out.read_text() == (GOLDEN / "nrmap" / "refmap.tsv").read_text()


def test_prefilter_taxon_list(tmp_path, on_cpu):
    """--taxon-list 9602: the host matcher's route, taken only because the
    option was given (QueryMatcherTaxonomyHook)."""
    out = tmp_path / "p"
    prefilter_kmer.reset_stats()
    run(["prefilter", TL / "qsub", TL / "tdb", out, "--taxon-list", "9602",
         "-s", "7.5"])
    assert entries_by_key(out) == entries_by_key(TL / "reftl")
    assert prefilter_kmer.STATS["taxon_queries"] == 6
    assert prefilter_kmer.STATS["flushes"] == 0
    prefilter_kmer.reset_stats()
    run(["prefilter", TL / "qsub", TL / "tdb", tmp_path / "p2", "-s", "7.5"])
    assert prefilter_kmer.STATS["taxon_queries"] == 0
    assert prefilter_kmer.STATS["flushes"] >= 1


def test_taxonomy_per_contig(tmp_path, on_cpu):
    """Nucleotide contigs against protein targets (taxpercontig.sh):
    extractorfs, the ORF prefilter with recoverlongestorf, per-ORF
    taxonomy through lcaalign, aggregatetaxweights and
    mergeresultsbyset."""
    out = tmp_path / "tax"
    run(["taxonomy", GOLDEN / "tpc" / "cdb", TL / "tdb", out,
         tmp_path / "tmp", "--tax-output-mode", 2])
    assert out.read_bytes() == (GOLDEN / "tpc" / "reftax").read_bytes()
    assert (pathlib.Path(str(out) + "_aln").read_bytes()
            == (GOLDEN / "tpc" / "reftax2_aln").read_bytes())


# -- a seeded set against the JAX package ------------------------------------

AA = "ARNDCQEGHILKMFPSTWYV"
RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
         "species"]


def _mutate(rng, s, rate):
    s = s.copy()
    mut = rng.random(len(s)) < rate
    s[mut] = rng.integers(0, 20, int(mut.sum()))
    return s


def write_tax_set(d: pathlib.Path):
    """Ten families of short proteins, six members each, and twelve
    unrelated decoys as targets; one mutated member fragment per family and
    two unrelated sequences as queries. A seven-rank taxonomy: family f's
    members are species of genus f (two species a genus, the sixth member
    of every third family in the next genus), every seventh target unmapped,
    one merged taxid. Returns the paths of the FASTAs, the dump and the
    accession mapping."""
    rng = np.random.default_rng(SEED)
    tseqs, tnames, ttax, qseqs = [], [], [], []
    for f in range(10):
        anc = rng.integers(0, 20, int(rng.integers(60, 120)))
        for m in range(6):
            tseqs.append(_mutate(rng, anc, rng.uniform(0.05, 0.15)))
            genus = f + 1 if (m == 5 and f % 3 == 0) else f
            tnames.append(f"T{len(tnames)}")
            ttax.append(3000 + 2 * (genus % 10) + m % 2)
        src = tseqs[-1 - int(rng.integers(6))]
        lo = int(rng.integers(0, len(src) // 4))
        qseqs.append(_mutate(rng, src[lo:], 0.35))
    for i in range(12):
        tseqs.append(rng.integers(0, 20, int(rng.integers(60, 120))))
        tnames.append(f"T{len(tnames)}")
        ttax.append(3000 + int(rng.integers(20)))
    for i in range(2):
        qseqs.append(rng.integers(0, 20, int(rng.integers(60, 120))))

    def fasta(path, names, seqs):
        path.write_text("".join(
            f">{n} synthetic protein {n}\n{''.join(AA[c] for c in s)}\n"
            for n, s in zip(names, seqs)))

    fasta(d / "t.fasta", tnames, tseqs)
    fasta(d / "q.fasta", [f"Q{i}" for i in range(len(qseqs))], qseqs)
    # nodes: root 1 -> superkingdom 2 -> phylum 10+p -> class 100+c ->
    # order 200+o -> family 500+f -> genus 1000+g -> species 3000+s
    nodes = [(1, 1, "no rank", "root"), (2, 1, "superkingdom", "Bacteria")]
    for p in range(2):
        nodes.append((10 + p, 2, "phylum", f"Phylum {p}"))
    for c in range(3):
        nodes.append((100 + c, 10 + c % 2, "class", f"Class {c}"))
    for o in range(4):
        nodes.append((200 + o, 100 + o % 3, "order", f"Order {o}"))
    for f in range(5):
        nodes.append((500 + f, 200 + f % 4, "family", f"Family {f}"))
    for g in range(10):
        nodes.append((1000 + g, 500 + g // 2, "genus", f"Genus {g}"))
    for s in range(20):
        nodes.append((3000 + s, 1000 + s // 2, "species",
                      f"Genus {s // 2} species {s}"))
    dump = d / "dump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text("".join(
        f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n" for t, p, r, _ in nodes))
    (dump / "names.dmp").write_text("".join(
        f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
        for t, _, _, n in nodes))
    (dump / "merged.dmp").write_text("9999\t|\t3001\t|\n")
    (dump / "delnodes.dmp").write_text("")
    mapping = d / "acc2taxid.tsv"
    mapping.write_text("".join(
        f"{n}\t{9999 if i == 1 else t}\n"
        for i, (n, t) in enumerate(zip(tnames, ttax)) if i % 7 != 6))
    return d / "q.fasta", d / "t.fasta", dump, mapping


LCA_MODES = (1, 3, 4)
OUT_MODES = (0, 1, 2)


@pytest.fixture(scope="module")
def taxset(tmp_path_factory):
    """The seeded set's DBs, and each package's taxonomy runs on it: one
    search per --lca-mode's search (the workflow's tmp kept, so the other
    output modes reuse it), easy-taxonomy, and the port's search result
    that the tools' tests share."""
    d = tmp_path_factory.mktemp("taxset")
    q_fa, t_fa, dump, mapping = write_tax_set(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, "cpu")
        run(["createdb", q_fa, d / "qdb"])
        run(["createdb", t_fa, d / "tdb"])
        run(["createtaxdb", d / "tdb", d / "tmp_c", "--ncbi-tax-dump", dump,
             "--tax-mapping-file", mapping])
        for pkg, runner in (("port", run), ("jax", run_jax)):
            for lca in LCA_MODES:
                tmp = d / f"{pkg}_tmp_{'lca' if lca == 3 else 'aln'}"
                for om in OUT_MODES:
                    runner(["taxonomy", d / "qdb", d / "tdb",
                            d / f"{pkg}_tax_{lca}_{om}", tmp,
                            "--lca-mode", lca, "--tax-output-mode", om,
                            "--remove-tmp-files", 0])
            runner(["easy-taxonomy", q_fa, d / "tdb", d / f"{pkg}_easy",
                    d / f"{pkg}_easy_tmp"])
    return d


@pytest.mark.parametrize("lca", LCA_MODES)
@pytest.mark.parametrize("om", OUT_MODES)
def test_taxonomy_parity(taxset, lca, om):
    """The taxonomy workflow (taxonomy.sh): the LCA DB, the alignment DB or
    both, as the JAX package writes them."""
    d = taxset
    port, jax_ = d / f"port_tax_{lca}_{om}", d / f"jax_tax_{lca}_{om}"
    assert db_bytes(port) == db_bytes(jax_)
    if om == 2:
        assert db_bytes(f"{port}_aln") == db_bytes(f"{jax_}_aln")
    if om in (0, 2):
        # top hit (4): species; 2bLCA (1, 3): mostly genus, some above
        lines = list(entries_by_key(port).values())
        rank = b"\tspecies\t" if lca == 4 else b"\tgenus\t"
        assert sum(rank in v for v in lines) >= 6


@pytest.mark.parametrize("suffix", ["_lca.tsv", "_report", "_tophit_report",
                                    "_tophit_aln"])
def test_easy_taxonomy_parity(taxset, suffix):
    """easy-taxonomy's four files (easytaxonomy.sh), byte for byte."""
    port = (taxset / f"port_easy{suffix}").read_bytes()
    assert port == (taxset / f"jax_easy{suffix}").read_bytes()
    assert port


def test_search_lca_search_parity(taxset):
    """search --lca-search (the taxonomy's search at --lca-mode 3) runs
    lcaalign in place of align: the same result DB as the JAX package's."""
    port, jax_ = (taxset / "port_tmp_lca" / "first",
                  taxset / "jax_tmp_lca" / "first")
    assert db_bytes(port) == db_bytes(jax_)
    assert db_bytes(port) != db_bytes(taxset / "port_tmp_aln" / "first")


TOOLS = {
    "lca": ["lca", "{tdb}", "{res}", "{out}", "--tax-lineage", "1",
            "--lca-ranks", "genus,family"],
    "majoritylca": ["majoritylca", "{tdb}", "{res}", "{out}",
                    "--majority", "0.6"],
    "addtaxonomy": ["addtaxonomy", "{tdb}", "{res}", "{out}",
                    "--tax-lineage", "2"],
    "filtertaxdb": ["filtertaxdb", "{tdb}", "{res}", "{out}",
                    "--taxon-list", "1002||500&&!3001"],
    "taxonomyreport": ["taxonomyreport", "{tdb}", "{lca}", "{out}"],
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tax_tools_parity(taxset, tmp_path, on_cpu, tool):
    """Each tool on the port's search result (align, --lca-mode 1) and, for
    the report, its LCA DB."""
    def args(pkg):
        return [a.format(tdb=taxset / "tdb",
                         res=taxset / "port_tmp_aln" / "first",
                         lca=taxset / "port_tax_1_0",
                         out=tmp_path / pkg) for a in TOOLS[tool]]
    run(args("port"))
    run_jax(args("jax"))
    if tool == "taxonomyreport":
        assert ((tmp_path / "port").read_bytes()
                == (tmp_path / "jax").read_bytes())
    else:
        assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")


@pytest.mark.parametrize("extra", [
    ["--max-rejected", "1"],
    ["--max-accept", "2", "--alignment-mode", "3", "-a"],
])
def test_lcaalign_parity(taxset, tmp_path, on_cpu, extra):
    """lcaalign alone on one prefilter result (-s 7.5, with two unrelated
    decoys put among each query's candidates): three waves of align_batch
    per block give the JAX package's per-candidate bytes. With
    --max-rejected 1 the lca pass breaks at a decoy: the pairs past the
    break were computed and dropped."""
    run(["prefilter", taxset / "qdb", taxset / "tdb", tmp_path / "p0",
         "-s", "7.5"])
    pref = tmp_path / "pref"
    with DBWriter(str(pref), dbt.DBTYPE_PREFILTER_RES) as w:
        for k, data in sorted(entries_by_key(tmp_path / "p0").items()):
            lines = data.splitlines(keepends=True)
            for at, decoy in ((1, 60 + k % 12), (3, 71 - k % 12)):
                lines.insert(at, f"{decoy}\t0\t0\n".encode())
            w.write(k, b"".join(lines))
    align_cmd.reset_lca_stats()
    run(["lcaalign", taxset / "qdb", taxset / "tdb", pref,
         tmp_path / "port", "-e", "10"] + extra)
    run_jax(["lcaalign", taxset / "qdb", taxset / "tdb", pref,
             tmp_path / "jax", "-e", "10"] + extra)
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")
    st = align_cmd.LCA_STATS
    assert st["pairs"][2] > 0 and st["used"][1] <= st["pairs"][1]
    if extra[0] == "--max-rejected":
        assert st["used"][2] < st["pairs"][2]


def test_convertalis_taxonomy_columns(taxset, tmp_path, on_cpu):
    fmt = "query,target,taxid,taxname,taxlineage,evalue"
    for pkg, runner in (("port", run), ("jax", run_jax)):
        runner(["convertalis", taxset / "qdb", taxset / "tdb",
                taxset / "port_tmp_aln" / "first", tmp_path / f"{pkg}.m8",
                "--format-output", fmt])
    port = (tmp_path / "port.m8").read_text()
    assert port == (tmp_path / "jax.m8").read_text()
    assert "Genus" in port and "\t0\tunclassified\t" in port


def test_easy_search_greedy_best_hits(taxset, tmp_path, on_cpu):
    """easy-search --greedy-best-hits: the port's search -a, then the JAX
    package's summarizeresult and convertalis on the port's result."""
    run(["easy-search", taxset / "q.fasta", taxset / "tdb",
         tmp_path / "port.m8", tmp_path / "tmp", "--greedy-best-hits", 1])
    aln, best = tmp_path / "aln", tmp_path / "best"
    run(["search", taxset / "qdb", taxset / "tdb", aln, tmp_path / "tmp2",
         "-a", "--alignment-mode", 3])
    run_jax(["summarizeresult", aln, best])
    run_jax(["convertalis", taxset / "qdb", taxset / "tdb", best,
             tmp_path / "jax.m8"])
    port = (tmp_path / "port.m8").read_text()
    assert port == (tmp_path / "jax.m8").read_text()
    assert 0 < len(port.splitlines()) < sum(
        v.count(b"\n") for v in entries_by_key(aln).values())


def test_createtaxdb_parity(taxset, tmp_path, on_cpu):
    """createtaxdb offline (--tax-db-mode 1 and 0): the port writes the JAX
    package's mapping and binary taxonomy."""
    q_fa, t_fa, dump, mapping = write_tax_set(tmp_path)
    for mode in (1, 0):
        for pkg, runner in (("port", run), ("jax", run_jax)):
            db = tmp_path / f"{pkg}{mode}"
            for suf in ("", ".index", ".dbtype", ".lookup", "_h",
                        "_h.index", "_h.dbtype"):
                shutil.copyfile(str(taxset / "tdb") + suf, str(db) + suf)
            runner(["createtaxdb", db, tmp_path / "tmp", "--ncbi-tax-dump",
                    dump, "--tax-mapping-file", mapping, "--tax-db-mode",
                    mode])
        files = (["_mapping", "_taxonomy"] if mode else
                 ["_mapping", "_names.dmp", "_nodes.dmp", "_merged.dmp"])
        for suf in files:
            assert (pathlib.Path(f"{tmp_path}/port{mode}{suf}").read_bytes()
                    == pathlib.Path(f"{tmp_path}/jax{mode}{suf}")
                    .read_bytes()), suf


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
d, tmp = sys.argv[1], sys.argv[2]
assert main(["easy-taxonomy", d + "/q.fasta", d + "/tdb", tmp + "/res",
             tmp + "/tmp"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_easy_taxonomy_loads_no_jax(taxset, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(taxset),
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert ((tmp_path / "res_lca.tsv").read_bytes()
            == (taxset / "port_easy_lca.tsv").read_bytes())
