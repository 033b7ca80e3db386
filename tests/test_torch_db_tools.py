"""The port's DB tools (`createsubdb`, `createtsv`, `mergedbs`,
`subtractdbs`, `filterdb`, `swapresults`, `tar2db`/`db2tar`/`unpackdb`,
`createseqfiledb`) and its prebuilt k-mer index (`indexdb`/`createindex`)
against the reference MMseqs2 goldens, with the CPU requested: result DBs
equal key by key, flat files byte for byte. The index round trip also holds
the JAX package's reader on the port's index file, and a prefilter against
the prebuilt index equals the golden `pref`."""

import os
import pathlib
import shutil

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
TOY = GOLDEN / "toy"


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


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def copy_db(src, dst):
    for suf in ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype",
                ".lookup", ".source"):
        s = pathlib.Path(str(src) + suf)
        if s.exists():
            shutil.copy(s, str(dst) + suf)


@pytest.mark.parametrize("mode", [0, 1])
def test_createsubdb(tmp_path, on_cpu, mode):
    """Both subdb modes keep each kept entry's bytes; the soft mode writes
    a key-sorted index over the source's data file (createsubdb.cpp)."""
    keys = tmp_path / "keys"
    keys.write_text("9\n2\n5\n")
    out = tmp_path / "sub"
    run(["createsubdb", keys, TOY / "qdb", out, "--subdb-mode", mode])
    assert os.path.islink(out) == (mode == 1)
    src = entries_by_key(TOY / "qdb")
    got = entries_by_key(out)
    assert sorted(got) == [2, 5, 9]
    assert all(got[k] == src[k] for k in got)
    assert os.path.islink(str(out) + "_h")


@pytest.mark.parametrize("extra,golden", [
    ([], "reft_x"),
    (["--target-column", "0"], "reft_xtargetcolumn0"),
    (["--full-header"], "reft_xfullheader"),
    (["--first-seq-as-repr"], "reft_xfirstseqasrepr"),
])
def test_createtsv_modes(tmp_path, on_cpu, extra, golden):
    out = tmp_path / "out.tsv"
    run(["createtsv", GOLDEN / "fm" / "qsub", TOY / "qdb",
         GOLDEN / "fm" / "alnsub", out, "--threads", "1"] + extra)
    assert out.read_bytes() == (GOLDEN / "ctsv" / golden).read_bytes()


def test_createtsv_three_arg_and_db_output(tmp_path, on_cpu):
    fm, ctsv = GOLDEN / "fm", GOLDEN / "ctsv"
    out = tmp_path / "out.tsv"
    run(["createtsv", fm / "qsub", fm / "alnsub", out, "--threads", "1"])
    assert out.read_bytes() == (ctsv / "reft_3col").read_bytes()
    db = tmp_path / "db"
    run(["createtsv", fm / "qsub", TOY / "qdb", fm / "alnsub", db,
         "--db-output", "1", "--threads", "1"])
    assert db.read_bytes() == (ctsv / "reft_db").read_bytes()
    assert pathlib.Path(str(db) + ".index").read_bytes() == \
        (ctsv / "reft_db.index").read_bytes()


def test_mergedbs_parity(tmp_path, on_cpu):
    out = tmp_path / "italn"
    run(["mergedbs", TOY / "it_profile_0", out, TOY / "it_aln_0",
         TOY / "it_aln_tmp_1"])
    assert out.read_bytes() == (TOY / "italn").read_bytes()
    assert pathlib.Path(str(out) + ".index").read_bytes() == \
        (TOY / "italn.index").read_bytes()


def test_mergedbs_filter_target(tmp_path, on_cpu):
    """mergedbs casclu out aln pref --merge-filter-target 1 (golden mf)."""
    out = tmp_path / "m"
    run(["mergedbs", TOY / "casclu", out, TOY / "aln", TOY / "pref",
         "--merge-filter-target", "1"])
    want = entries_by_key(GOLDEN / "mf" / "refm")
    assert entries_by_key(out) == want


def test_subtractdbs_parity(tmp_path, on_cpu):
    out = tmp_path / "pref_1"
    run(["subtractdbs", TOY / "it_pref_tmp_1", TOY / "it_aln_0", out,
         "-e", "0.001", "--e-profile", "0.1"])
    assert entries_by_key(out) == entries_by_key(TOY / "it_pref_1")


@pytest.mark.parametrize("args,gold", [
    (["--filter-column", "2", "--comparison-operator", "ge",
      "--comparison-value", "100"], "fdb_num"),
    (["--extract-lines", "5"], "fdb_lines"),
    (["--filter-column", "2", "--beats-first",
      "--comparison-operator", "le"], "fdb_beats"),
    (["--filter-column", "2", "--sort-entries", "1"], "fdb_sort"),
    (["--filter-column", "2", "--trim-to-one-column"], "fdb_trim"),
    (["--filter-column", "3", "--filter-regex", "^-[0-9]*$"], "fdb_regex"),
])
def test_filterdb_modes_parity(tmp_path, on_cpu, args, gold):
    src = "aln" if gold in ("fdb_beats", "fdb_trim") else "pref"
    out = tmp_path / "f"
    run(["filterdb", TOY / src, out] + args)
    assert entries_by_key(out) == entries_by_key(TOY / gold)


def test_swapresults_matches_the_jax_package(tmp_path, on_cpu):
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    args = [str(TOY / "qdb"), str(TOY / "qdb"), str(TOY / "aln")]
    run(["swapresults", *args, tmp_path / "port"])
    cmd = get_command("swapresults")
    par = Params().parse([*args, str(tmp_path / "jax")], cmd, cmd.min_db,
                         cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    got = entries_by_key(tmp_path / "port")
    assert got == entries_by_key(tmp_path / "jax") and len(got) == 500


def test_tar2db_db2tar_unpackdb(tmp_path, on_cpu):
    dbops = GOLDEN / "dbops"
    out = tmp_path / "tardb"
    run(["tar2db", dbops / "m.tar", out, "--tar-include",
         r".*\.(txt|txt\.gz)$"])
    for suf in ("", ".index", ".dbtype", ".lookup", ".source"):
        assert pathlib.Path(str(out) + suf).read_bytes() == \
            pathlib.Path(str(dbops / "tardb") + suf).read_bytes(), suf
    tar = tmp_path / "out.tar"
    run(["db2tar", dbops / "tardb", tar])
    back = tmp_path / "back"
    run(["tar2db", tar, back, "--tar-exclude", r".*\.gz$"])
    want = entries_by_key(dbops / "tardb")
    assert entries_by_key(back) == {k: want[k] for k in (0, 1)}
    flat = tmp_path / "flat"
    run(["unpackdb", dbops / "tardb", flat])
    assert sorted(p.name for p in flat.iterdir()) == \
        ["a.txt", "b.txt", "c.txt.gz"]
    assert (flat / "a.txt").read_bytes() == b"hello A\n"


def test_createseqfiledb_hhformat(tmp_path, on_cpu):
    out = tmp_path / "c"
    run(["createseqfiledb", TOY / "qdb", TOY / "casclu", out,
         "--hh-format", "1"])
    assert entries_by_key(out) == entries_by_key(GOLDEN / "csf" / "refc")


def test_index_roundtrip(tmp_path, on_cpu):
    """The port writes the JAX package's index format: both readers load
    it with the table the port's prefilter builds."""
    from mmseqs2_tpu.prefilter.index_io import load_index as jax_load
    from mmseqs2_tpu_torch.prefilter.index_io import load_index
    db = tmp_path / "tdb"
    copy_db(TOY / "qdb", db)
    run(["indexdb", db, db])
    table, meta = load_index(str(db) + ".idx")
    assert meta["k"] == table.k == 6
    assert len(table.masked_seqs) == meta["n_seqs"] == 500
    assert len(table.entries_seq) == len(table.entries_pos)
    assert table.offsets[-1] == len(table.entries_seq)
    jtable, jmeta = jax_load(str(db) + ".idx")
    assert jmeta == meta
    assert (jtable.entries_seq == table.entries_seq).all()
    assert (jtable.offsets == table.offsets).all()


def test_prefilter_with_prebuilt_index_parity(tmp_path, on_cpu,
                                              monkeypatch):
    """prefilter against a `createindex`-built <db>.idx equals the golden
    `pref` on 8 queries, and builds no index of its own."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    db = tmp_path / "tdb"
    copy_db(TOY / "qdb", db)
    run(["createindex", db])
    keys = tmp_path / "keys"
    keys.write_text("".join(f"{k}\n" for k in range(8)))
    run(["createsubdb", keys, db, tmp_path / "qsub"])
    run(["createsubdb", keys, str(db) + "_h", str(tmp_path / "qsub") + "_h"])

    def no_build(*args, **kwargs):
        raise AssertionError("the prebuilt index was not used")
    monkeypatch.setattr(prefilter_kmer, "build_index", no_build)
    out = tmp_path / "pref"
    run(["prefilter", tmp_path / "qsub", db, out, "--add-self-matches"])
    got, want = entries_by_key(out), entries_by_key(TOY / "pref")
    for k in range(8):
        assert got[k] == want[k], k




@pytest.mark.parametrize("extra", [["--mask", "0"],
                                   ["--mask-lower-case", "1"]])
def test_makepaddedseqdb_of_a_nucleotide_db_matches_the_jax_command(
        tmp_path, on_cpu, extra):
    """A nucleotide DB goes through the amino-acid table, as the JAX
    command takes it (its db_tools.py:659-660): every file equal."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    ndb = GOLDEN / "nucl" / "ndb"
    run(["makepaddedseqdb", ndb, tmp_path / "port", *extra])
    cmd = get_command("makepaddedseqdb")
    par = Params().parse([str(ndb), str(tmp_path / "jax"), *extra], cmd,
                         cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    for suf in ("", ".index", ".dbtype", ".lookup", "_h", "_h.index",
                "_h.dbtype"):
        assert ((tmp_path / f"port{suf}").read_bytes()
                == (tmp_path / f"jax{suf}").read_bytes()), suf
    with DBReader(str(tmp_path / "port")) as r:
        assert r.size == 61 and r.base_type == 1      # nucleotides
