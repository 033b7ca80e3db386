"""The port's nucleotide tools, nucleotide and translated search, and
clustering of nucleotide DBs, with the CPU requested, against the reference
MMseqs2 goldens (tests/golden/{nucl,nuclx,offa,nlc}; tests/golden/README.md
gives their commands) and, where no golden exists, the JAX package's output
on the same input: createdb, extractframes, extractorfs, offsetalignment
(blastn and translated coordinates, --merge-query 0, --chain-alignments),
result2dnamsa, proteinaln2nucl, translatenucs, splitsequence, the
nucleotide prefilter (with and without a prebuilt index), `search
--search-type 3` and `2`, a translated search against a protein DB,
kmermatcher, linclust, cluster and clusthash. Also: a nucleotide
easy-search loads neither JAX nor the JAX package. JAX is imported only
inside the tests that compare with it."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
G = REPO / "tests" / "golden"
NUCL = G / "nucl"
NDB = NUCL / "ndb"


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


def run_jax(name, args):
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    cmd = get_command(name)
    par = Params().parse([str(a) for a in args], cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def same_files(a, b, suffixes=("", ".index", ".dbtype")):
    for suf in suffixes:
        assert (pathlib.Path(f"{a}{suf}").read_bytes()
                == pathlib.Path(f"{b}{suf}").read_bytes()), suf


def sub_db(src, n, dst):
    """The first n entries of a sequence DB and of its header DB."""
    for suf in ("", "_h"):
        with DBReader(f"{src}{suf}") as r, \
                DBWriter(f"{dst}{suf}", r.base_type, r.extended_type) as w:
            for i in range(min(n, r.size)):
                w.write(r.get_db_key(i), r.get_data(i))
    return dst


# -- the nucleotide tools against their goldens -----------------------------

def test_createdb_nucl_golden(tmp_path, on_cpu):
    out = tmp_path / "ndb"
    run(["createdb", NUCL / "NUCL.fasta", out])
    same_files(out, NDB)


def test_extractframes_golden(tmp_path, on_cpu):
    """blastn.sh's query frames: forward frame 1 and reverse frame 1."""
    out = tmp_path / "qf"
    run(["extractframes", NDB, out, "--forward-frames", "1",
         "--reverse-frames", "1"])
    same_files(out, NUCL / "n_query_seqs", ("", "_h"))


def test_extractorfs_golden(tmp_path, on_cpu):
    """The translated ORFs and their headers (source key, frame
    coordinates, incomplete-end flags)."""
    out = tmp_path / "orfs"
    run(["extractorfs", NDB, out, "--translate", "1"])
    same_files(out, NUCL / "t_q_orfs_aa", ("", "_h"))


@pytest.mark.parametrize("search_type,orfs,aln,golden", [
    ("3", "n_query_seqs", "n_aln", "naln"),
    ("2", "t_q_orfs_aa", "t_aln", "taln")], ids=["nucleotide", "translated"])
def test_offsetalignment_golden(tmp_path, on_cpu, search_type, orfs, aln,
                                golden):
    """Frame and ORF coordinates mapped back to the contigs (x3 for the
    translated search)."""
    out = tmp_path / "off"
    tgt = NDB if search_type == "3" else NUCL / orfs
    run(["offsetalignment", NDB, NUCL / orfs, NDB, tgt, NUCL / aln, out,
         "--search-type", search_type])
    assert entries_by_key(out) == entries_by_key(NUCL / golden)


@pytest.mark.parametrize("extra,golden", [
    ([], "refoff"), (["--merge-query", "0"], "refoff_nm"),
    (["--chain-alignments", "1"], "refoff_ch")],
    ids=["merged", "merge-query 0", "chain-alignments"])
def test_offsetalignment_modes_golden(tmp_path, on_cpu, extra, golden):
    """Translated ORFs of contigs against a protein DB: per-contig merged
    entries, per-ORF entries keyed by the contig (duplicate keys, as the
    reference writes them), and chained same-diagonal hits."""
    off, tl = G / "offa", G / "tl"
    out = tmp_path / "off"
    run(["offsetalignment", off / "cdb", off / "orfn", tl / "tdb",
         tl / "tdb", off / "orfaln", out, "--threads", "1", *extra])
    with DBReader(str(out)) as a, DBReader(str(off / golden)) as b:
        got = sorted((a.get_db_key(i), a.get_data(i)) for i in range(a.size))
        want = sorted((b.get_db_key(i), b.get_data(i))
                      for i in range(b.size))
    assert got == want


def test_result2dnamsa_golden(tmp_path, on_cpu):
    out = tmp_path / "dnamsa"
    run(["result2dnamsa", NDB, NDB, G / "nuclx" / "nres", out])
    same_files(out, G / "nuclx" / "dnamsa", ("", ".index"))


def test_proteinaln2nucl_golden(tmp_path, on_cpu):
    x = G / "nuclx"
    out = tmp_path / "pnucl"
    run(["proteinaln2nucl", NDB, NDB, x / "taa", x / "taa", x / "palnf",
         out])
    same_files(out, x / "pnucl", ("", ".index"))


def test_translatenucs_equals_jax(tmp_path, on_cpu):
    """translatenucs of ndb, and with --add-orf-stop of its nucleotide ORFs
    (their headers carry the incomplete-start/end flags), equal the JAX
    package's."""
    orfs = tmp_path / "orfs"
    run(["extractorfs", NDB, orfs])
    for name, src, extra in (("aa", NDB, []),
                             ("aa_stop", orfs, ["--add-orf-stop", "1"])):
        run(["translatenucs", src, tmp_path / name, *extra])
        run_jax("translatenucs", [src, tmp_path / f"j{name}", *extra])
        same_files(tmp_path / name, tmp_path / f"j{name}")
    assert b"*" in (tmp_path / "aa_stop").read_bytes()


@pytest.mark.parametrize("src,extra", [
    ("ndb", ["--max-seq-len", "300", "--sequence-overlap", "50"]),
    ("n_query_seqs", ["--max-seq-len", "400", "--sequence-overlap", "100"]),
    ("n_query_seqs", ["--max-seq-len", "400", "--headers-split-mode", "1"]),
    ("ndb", [])], ids=["contigs", "frames", "headers-split-mode 1",
                       "nothing to split"])
def test_splitsequence_equals_jax(tmp_path, on_cpu, src, extra):
    """Chunks and their headers (frame headers of the minus strand count
    down) equal the JAX package's; with nothing longer than the limit the
    output links the input."""
    run(["splitsequence", NUCL / src, tmp_path / "s", *extra])
    run_jax("splitsequence", [NUCL / src, tmp_path / "j", *extra])
    same_files(tmp_path / "s", tmp_path / "j", ("", ".index", "_h",
                                                 "_h.index"))
    if not extra:
        assert os.path.islink(tmp_path / "s")


# -- the nucleotide prefilter, search and the index ---------------------------

def test_nucl_prefilter_golden(tmp_path, on_cpu):
    """Exact 15-mers with the 5-letter matrix on the host matcher, as
    blastn.sh runs it: equal to n_pref on every query."""
    out = tmp_path / "pref"
    run(["prefilter", NUCL / "n_query_seqs", NDB, out, "-k", "15",
         "--exact-kmer-matching", "1", "--max-seq-len", "10000", "-s",
         "5.7"])
    assert entries_by_key(out) == entries_by_key(NUCL / "n_pref")


def test_indexdb_nucl_equals_jax(tmp_path, on_cpu, monkeypatch):
    """indexdb of a nucleotide DB writes the JAX package's index (k 15,
    threshold 0, the nucleotide flag), and the nucleotide prefilter loads it
    in place of building one: equal to n_pref."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.prefilter.index_io import load_index_meta
    db = tmp_path / "ndb"
    for suf in ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype"):
        (tmp_path / f"ndb{suf}").write_bytes(
            pathlib.Path(f"{NDB}{suf}").read_bytes())
    run(["indexdb", db, db])
    run_jax("indexdb", [db, tmp_path / "jndb"])
    assert (entries_by_key(f"{db}.idx")
            == entries_by_key(tmp_path / "jndb.idx"))
    meta = load_index_meta(f"{db}.idx")
    assert (meta["nucl"], meta["k"], meta["kmer_thr"]) == (1, 15, 0)

    def no_build(*args, **kwargs):
        raise AssertionError("the prebuilt index was not used")
    monkeypatch.setattr(prefilter_kmer, "build_index", no_build)
    out = tmp_path / "pref"
    run(["prefilter", NUCL / "n_query_seqs", db, out,
         "--exact-kmer-matching", "1", "--max-seq-len", "10000"])
    assert entries_by_key(out) == entries_by_key(NUCL / "n_pref")


@pytest.mark.parametrize("search_type,golden", [("3", "naln"), ("2", "taln")],
                         ids=["nucleotide", "translated"])
def test_search_golden(tmp_path, on_cpu, search_type, golden):
    """search ndb ndb --search-type 3 (blastn.sh: frames, splits, exact
    15-mers, the banded ksw2 aligner) and 2 (translated_search.sh: ORFs,
    the protein prefilter and align, x3 coordinates) equal the reference's
    result on every contig."""
    out = tmp_path / "aln"
    run(["search", NDB, NDB, out, tmp_path / "tmp", "--search-type",
         search_type])
    assert entries_by_key(out) == entries_by_key(NUCL / golden)


def test_search_nucl_without_search_type_dies(tmp_path, on_cpu):
    """Two nucleotide DBs at --search-type 0 stop with the reference's
    message before any step runs."""
    with pytest.raises(SystemExit):
        cli.main(["search", str(NDB), str(NDB), str(tmp_path / "aln"),
                  str(tmp_path / "tmp")])
    assert not (tmp_path / "aln.dbtype").exists()
    assert not list((tmp_path / "tmp").glob("*/*.dbtype"))


@pytest.mark.parametrize("side", ["query", "target"])
def test_translated_search_one_nucleotide_side_equals_jax(tmp_path, on_cpu,
                                                          side):
    """One side nucleotide at the default search type: the ORFs of 8
    contigs against 150 ORF proteins (blastx-style), or 40 ORF proteins
    against the ORFs of 8 contigs (tblastn-style, hits mapped to contig
    coordinates on the target side), equal to the JAX package's search."""
    contigs = sub_db(NDB, 8, tmp_path / "contigs")
    proteins = sub_db(NUCL / "t_q_orfs_aa",
                      150 if side == "query" else 40, tmp_path / "proteins")
    q, t = (contigs, proteins) if side == "query" else (proteins, contigs)
    run(["search", q, t, tmp_path / "aln", tmp_path / "tmp"])
    run_jax("search", [q, t, tmp_path / "jaln", tmp_path / "jtmp"])
    got = entries_by_key(tmp_path / "aln")
    assert got == entries_by_key(tmp_path / "jaln")
    assert sorted(got) == sorted(entries_by_key(q)) and any(got.values())


# -- clustering of a nucleotide DB -----------------------------------------

@pytest.mark.parametrize("extra,golden", [
    ([], "refkm1"), (["--adjust-kmer-len", "1"], "refadj")],
    ids=["default", "adjust-kmer-len"])
def test_kmermatcher_nucl_golden(tmp_path, on_cpu, extra, golden):
    out = tmp_path / "km"
    run(["kmermatcher", NDB, out, "--threads", "1", "--linclust-version",
         "1", *extra])
    assert entries_by_key(out) == entries_by_key(G / "nlc" / golden)


def test_linclust_nucl_golden(tmp_path, on_cpu):
    """linclust --linclust-version 1 of ndb: the reverse-complement
    canonical k-mers, reversed hits through rescorediagonal and align, and
    no substitution rescore for nucleotides (Linclust.cpp:129)."""
    out = tmp_path / "clu"
    run(["linclust", NDB, out, tmp_path / "tmp", "--threads", "1",
         "--linclust-version", "1"])
    assert entries_by_key(out) == entries_by_key(G / "nlc" / "refclu")


@pytest.mark.parametrize("cmd", ["linclust", "cluster"])
def test_clustering_nucl_equals_jax(tmp_path, on_cpu, cmd):
    """linclust at its defaults (version 2, align2clust) and the cascaded
    cluster workflow (the nucleotide prefilter and aligner each round) of
    ndb equal the JAX package's cluster DBs."""
    run([cmd, NDB, tmp_path / "clu", tmp_path / "tmp"])
    run_jax(cmd, [NDB, tmp_path / "jclu", tmp_path / "jtmp"])
    got = entries_by_key(tmp_path / "clu")
    assert got == entries_by_key(tmp_path / "jclu")
    assert sum(v.count(b"\n") for v in got.values()) == 61


def test_clusthash_nucl_equals_jax(tmp_path, on_cpu):
    """The hash of each sequence or its reverse complement, whichever is
    smaller: equal to the JAX package's on ndb and on a set of a sequence,
    its reverse complement (same bucket, identity too low to link) and a
    copy (linked)."""
    ch, rc = tmp_path / "rc.fasta", tmp_path / "rc"
    seq = "ACGTTGCAAGGCTTACCGATCGATTTACGGCATCGATCGGATCCATGCAA"
    comp = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
    ch.write_text(f">a\n{seq}\n>b\n{comp}\n>c\n{seq}\n")
    run(["createdb", ch, rc])
    for db in (NDB, rc):
        run(["clusthash", db, tmp_path / "ch"])
        run_jax("clusthash", [db, tmp_path / "jch"])
        assert (entries_by_key(tmp_path / "ch")
                == entries_by_key(tmp_path / "jch"))
    got = entries_by_key(tmp_path / "ch")
    assert [v.count(b"\n") for _, v in sorted(got.items())] == [2, 1, 1]


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
fasta, tmp = sys.argv[1], sys.argv[2]
assert main(["easy-search", fasta, fasta, tmp + "/out.m8", tmp + "/tmp",
             "--search-type", "3"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_easy_search_nucl_loads_no_jax(tmp_path):
    """`easy-search --search-type 3` of NUCL.fasta against itself runs in a
    process that imports neither JAX nor the JAX package, and writes the
    reference's 165 alignments."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN,
                        str(NUCL / "NUCL.fasta"), str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    want = sum(v.count(b"\n") for v in entries_by_key(NUCL / "naln").values())
    assert len((tmp_path / "out.m8").read_text().splitlines()) == want
