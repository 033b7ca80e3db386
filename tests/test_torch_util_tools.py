"""The port's DB and result utilities (`commands/util_tools.py` whole,
`tsv2db` and `mergeresultsbyset` of `multihit.py`, `diffseqdbs` and
`recoverlongestorf` of `misc_tools.py`) and the branches they unlock
(`cluster --cluster-reassign`, `clusterupdate`), with the CPU requested.
Tolerance: byte equality throughout.

- Against the reference MMseqs2 goldens: `golden/toy/util` (the cases of
  test_parity_toy.py), `golden/misc` (diffseqdbs, recoverlongestorf),
  `golden/multihit` (mergeresultsbyset), `golden/reassign/refclu` and
  `golden/cu`.
- Against the JAX package on the same inputs, where no golden exists:
  `summarizealis`, `aliasdb` and `tsv2db`.
"""

import os
import pathlib
import shutil

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import cluster_wf
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.params import Params
from mmseqs2_tpu_torch.registry import get_command
from mmseqs2_tpu_torch.workflow import Workflow

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
TOY = GOLDEN / "toy"
UTIL = TOY / "util"
MISC = GOLDEN / "misc"
NUCL = GOLDEN / "nucl"


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
    return (pathlib.Path(path).read_bytes(),
            pathlib.Path(str(path) + ".index").read_bytes())


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


@pytest.mark.parametrize("cmd,inp,gold", [
    ("prefixid", "pref", "refpfx"),
    ("suffixid", "pref", "refsfx"),
    ("sortresult", "aln", "refsort"),
    ("summarizeresult", "aln", "refsumm"),
    ("swapdb", "aln", "refswap"),
    ("reverseseq", "qdb", "refrev"),
    ("masksequence", "qdb", "refmask"),
])
def test_util_two_arg(tmp_path, on_cpu, cmd, inp, gold):
    out = tmp_path / "out"
    run([cmd, TOY / inp, out])
    assert db_bytes(out) == db_bytes(UTIL / gold)


def test_convert2fasta(tmp_path, on_cpu):
    out = tmp_path / "o.fasta"
    run(["convert2fasta", TOY / "qdb", out])
    assert out.read_text() == (UTIL / "conv.fasta").read_text()


def test_result2flat(tmp_path, on_cpu):
    out = tmp_path / "o.flat"
    run(["result2flat", TOY / "qdb", TOY / "qdb", TOY / "aln", out])
    assert out.read_text() == (UTIL / "aln.flat").read_text()


def test_splitdb(tmp_path, on_cpu):
    out = tmp_path / "sp"
    run(["splitdb", TOY / "qdb", out, "--split", 3])
    for i in range(3):
        assert db_bytes(f"{out}_{i}_3") == db_bytes(UTIL / f"refsplit_{i}_3")


def test_renamedbkeys(tmp_path, on_cpu):
    out = tmp_path / "ren"
    run(["renamedbkeys", UTIL / "map.tsv", TOY / "pref", out])
    assert db_bytes(out) == db_bytes(UTIL / "refren")


def test_orftocontig(tmp_path, on_cpu):
    out = tmp_path / "orf"
    run(["orftocontig", NUCL / "ndb", NUCL / "t_q_orfs_aa", out])
    assert db_bytes(out) == db_bytes(UTIL / "reforf")


def test_summarizealis_parity(tmp_path, on_cpu):
    """Per-query alignment summary of the golden alignment DB."""
    run(["summarizealis", TOY / "aln", tmp_path / "port"])
    run_jax(["summarizealis", TOY / "aln", tmp_path / "jax"])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")


def test_aliasdb_parity(tmp_path, on_cpu):
    for pkg, runner in (("port", run), ("jax", run_jax)):
        runner(["aliasdb", TOY / "qdb", tmp_path / pkg])
    for suf in ("", ".index", ".dbtype", ".lookup", "_h", "_h.index"):
        port, jax_ = (pathlib.Path(f"{tmp_path}/{pkg}{suf}")
                      for pkg in ("port", "jax"))
        assert os.path.islink(port)
        assert os.readlink(port) == os.readlink(jax_)


def test_diffseqdbs(tmp_path, on_cpu):
    rm, kept, new = (tmp_path / n for n in ("rm", "kept", "new"))
    run(["diffseqdbs", TOY / "qdb", MISC / "subdb", rm, kept, new])
    assert rm.read_text() == (MISC / "rm.txt").read_text()
    assert kept.read_text() == (MISC / "kept.txt").read_text()
    assert new.read_text() == (MISC / "new.txt").read_text()


def test_recoverlongestorf(tmp_path, on_cpu):
    out = tmp_path / "reclorf"
    run(["recoverlongestorf", MISC / "orfs", MISC / "orfres", out])
    # the reference iterates an unordered_set: compare as sets
    assert (sorted(out.read_text().splitlines())
            == sorted((MISC / "reclorf").read_text().splitlines()))


def test_mergeresultsbyset(tmp_path, on_cpu):
    mh = GOLDEN / "multihit"
    out = tmp_path / "o"
    run(["mergeresultsbyset", mh / "qdb_set_to_member", mh / "bhps", out])
    assert entries_by_key(out) == entries_by_key(mh / "merged")


@pytest.mark.parametrize("dbtype", [0, 6])
def test_tsv2db_parity(tmp_path, on_cpu, dbtype):
    """Runs of one first column merge into one entry; a key that comes
    back later starts a second entry, as in the reference."""
    tsv = tmp_path / "in.tsv"
    tsv.write_text("3\t3\n3\t7\n1\tx\ty\n\n9\t9\n3\t5\n2\n")
    for pkg, runner in (("port", run), ("jax", run_jax)):
        runner(["tsv2db", tsv, tmp_path / pkg, "--output-dbtype", dbtype])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")
    assert ((tmp_path / "port.dbtype").read_bytes()
            == (tmp_path / "jax.dbtype").read_bytes())


def test_cluster_reassign_stage(tmp_path, on_cpu):
    """--cluster-reassign (cascaded_clustering.sh:161-283) from the cascade's
    merged clustering, which is the golden `casclu`: align, subtractdbs,
    swapdb, the prefilter and align of the wrongly assigned members, tsv2db
    of the lost singletons, mergedbs and clust give `reassign/refclu`."""
    cmd = get_command("cluster")
    par = Params().parse(
        [str(TOY / "qdb"), str(tmp_path / "out"), str(tmp_path / "tmp"),
         "--cluster-reassign", "--cluster-version", "1",
         "--linclust-version", "1"], cmd, cmd.min_db, cmd.max_db)
    cluster_wf.set_cluster_defaults(par)
    wf = Workflow(str(tmp_path / "tmp"))
    clu = wf.path("clu")
    for suf in ("", ".index", ".dbtype"):
        shutil.copyfile(str(TOY / "casclu") + suf, clu + suf)
    cluster_wf._cluster_reassign(par, wf, str(TOY / "qdb"), clu,
                                 str(tmp_path / "out"))
    got = entries_by_key(tmp_path / "out")
    assert got == entries_by_key(GOLDEN / "reassign" / "refclu")
    assert got != entries_by_key(TOY / "casclu")


@pytest.mark.slow
def test_cluster_reassign_workflow(tmp_path, on_cpu):
    out = tmp_path / "clu"
    run(["cluster", TOY / "qdb", out, tmp_path / "tmp", "--cluster-reassign",
         "--cluster-version", 1, "--linclust-version", 1])
    assert entries_by_key(out) == entries_by_key(
        GOLDEN / "reassign" / "refclu")


def test_clusterupdate(tmp_path, on_cpu):
    """update_clustering.sh: old DB = toy records 0-39, new DB = records
    5-54 (5 removed, 15 added)."""
    cu = GOLDEN / "cu"
    newmap, newclu = tmp_path / "newmapdb", tmp_path / "newclu"
    run(["clusterupdate", cu / "olddb", cu / "newdb", cu / "oldclu", newmap,
         newclu, tmp_path / "tmp", "--linclust-version", 1])
    assert entries_by_key(newclu) == entries_by_key(cu / "newclu")
    assert entries_by_key(newmap) == entries_by_key(cu / "newmapdb")
