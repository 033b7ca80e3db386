"""The port's clustering workflows (`linclust`, `cluster`, `easy-linclust`,
`easy-cluster`) with the CPU requested: every toy sequence assigned exactly
once, and the cluster DBs and output files equal to the JAX package's on the
same input; the full-toy linclust v1 and cascaded cluster runs against the
reference MMseqs2 goldens (`linclu`, `casclu`; slow). Also: easy-cluster
loads neither JAX nor the JAX package, and the clustering branches that are
not ported say so before any step runs."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
N_EASY_CLUSTER = 100


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


def check_full_assignment(clu_path, n_source):
    """Each sequence in exactly one cluster, each representative in its own
    cluster; returns the number of clusters."""
    members, reps, total = set(), set(), 0
    with DBReader(str(clu_path)) as clu:
        for i in range(clu.size):
            reps.add(clu.get_db_key(i))
            for line in clu.get_data(i).split(b"\n"):
                if line:
                    members.add(int(line.split(b"\t")[0]))
                    total += 1
        n = clu.size
    assert total == n_source and len(members) == n_source
    assert reps <= members
    return n


@pytest.mark.parametrize("extra", [
    [],
    ["--clust-hash", "1"],
    ["--include-align-files", "1", "-a"],
], ids=["plain", "clust-hash", "align-files"])
def test_linclust_v2(tmp_path, on_cpu, extra):
    out = tmp_path / "clu"
    run(["linclust", GOLDEN / "qdb", out, tmp_path / "tmp", "--threads",
         "1"] + extra)
    assert check_full_assignment(out, 500) > 400   # mostly non-redundant
    run_jax("linclust", [GOLDEN / "qdb", tmp_path / "jax", tmp_path / "jtmp",
                         "--threads", "1"] + extra)
    assert entries_by_key(out) == entries_by_key(tmp_path / "jax")
    if "--include-align-files" in extra:
        aln = entries_by_key(str(out) + "_aln")
        assert aln == entries_by_key(str(tmp_path / "jax") + "_aln")
        clu = entries_by_key(out)
        for rep, data in clu.items():       # a record for every member
            members = {int(x) for x in data.split()}
            targets = {int(line.split(b"\t")[0])
                       for line in aln[rep].split(b"\n") if line}
            assert members - {rep} <= targets


OUTPUTS = ("_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta")


def test_easy_linclust_matches_the_jax_package(tmp_path, on_cpu):
    fasta = GOLDEN / "QUERY.fasta"
    run(["easy-linclust", fasta, tmp_path / "port", tmp_path / "tmp"])
    run_jax("easy-linclust", [fasta, tmp_path / "jax", tmp_path / "jtmp"])
    got = {}
    for suf in OUTPUTS:
        got[suf] = pathlib.Path(str(tmp_path / "port") + suf).read_bytes()
        assert got[suf] == \
            pathlib.Path(str(tmp_path / "jax") + suf).read_bytes()
    # _all_seqs.fasta: each cluster's representative line, then its members
    n_reps = got["_rep_seq.fasta"].count(b">")
    assert got["_all_seqs.fasta"].count(b">") == 500 + n_reps


def test_easy_cluster_matches_the_jax_package(tmp_path, on_cpu):
    """The cascaded workflow (linclust v2 redundancy pass, then prefilter,
    align and clust rounds) on the first toy sequences, at MMseqs2's README
    parameters."""
    records = (GOLDEN / "QUERY.fasta").read_text().split(">")[1:]
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(">" + r for r in records[:N_EASY_CLUSTER]))
    flags = ["--min-seq-id", "0.5", "-c", "0.8", "--cov-mode", "1"]
    run(["easy-cluster", fasta, tmp_path / "port", tmp_path / "tmp"] + flags)
    run_jax("easy-cluster", [fasta, tmp_path / "jax", tmp_path / "jtmp"]
            + flags)
    for suf in OUTPUTS:
        got = pathlib.Path(str(tmp_path / "port") + suf).read_bytes()
        assert got == pathlib.Path(str(tmp_path / "jax") + suf).read_bytes()
    tsv = pathlib.Path(str(tmp_path / "port") + "_cluster.tsv").read_text()
    assert len(tsv.splitlines()) == N_EASY_CLUSTER


@pytest.mark.slow
def test_linclust_workflow_parity(tmp_path, on_cpu):
    """The golden comes from the reference forced to --linclust-version 1."""
    out = tmp_path / "linclu"
    run(["linclust", GOLDEN / "qdb", out, tmp_path / "tmp",
         "--linclust-version", "1"])
    assert entries_by_key(out) == entries_by_key(GOLDEN / "linclu")


@pytest.mark.slow
def test_cluster_workflow_parity(tmp_path, on_cpu):
    out = tmp_path / "casclu"
    run(["cluster", GOLDEN / "qdb", out, tmp_path / "tmp",
         "--linclust-version", "1"])
    assert entries_by_key(out) == entries_by_key(GOLDEN / "casclu")


QDB = GOLDEN / "qdb"

UNPORTED = {
    "cluster profile": ["cluster", GOLDEN / "it_profile_0", "{out}",
                        "{tmp}"],
    "cluster v2 profile": ["cluster", GOLDEN / "it_profile_0", "{out}",
                           "{tmp}", "--cluster-version", "2",
                           "--switch-consensus-rep", "1"],
    "linclust profile": ["linclust", GOLDEN / "it_profile_0", "{out}",
                         "{tmp}"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_clustering_branch_says_so(tmp_path, on_cpu, name):
    args = [str(a).format(out=tmp_path / "out", tmp=tmp_path / "tmp")
            for a in UNPORTED[name]]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(args)
    assert not (tmp_path / "out.dbtype").exists()
    assert not (tmp_path / "tmp").exists()


# `python -m mmseqs2_tpu_torch ...` as the interpreter runs it (runpy),
# then the modules it loaded
SUBPROCESS_RUN = r"""
import runpy
import sys
sys.argv = ["mmseqs2_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("mmseqs2_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    print("EXIT", e.code)
assert "mmseqs2_tpu_torch.commands.cluster_wf" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
"""


def test_easy_cluster_loads_no_jax(tmp_path):
    """`python -m mmseqs2_tpu_torch easy-cluster` imports neither JAX nor
    the JAX package."""
    records = (GOLDEN / "QUERY.fasta").read_text().split(">")[1:]
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(">" + r for r in records[:40]))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", SUBPROCESS_RUN, "easy-cluster", str(fasta),
         str(tmp_path / "out"), str(tmp_path / "tmp")], env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "EXIT 0" in r.stdout and "LOADED []" in r.stdout, r.stdout
    tsv = (tmp_path / "out_cluster.tsv").read_text().splitlines()
    assert len(tsv) == 40
