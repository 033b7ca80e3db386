"""The port's proteome commands (`commands/proteome.py`: `proteomecluster`,
`parseproteomealignments`, `pickrepprofile`, `pickconsensusrep`,
`pickconsensusrepfast`, `easy-proteomecluster`, `easy-proteomesearch`) and
the branch they unlock, `cluster`/`linclust --switch-consensus-rep`, with
the CPU requested. Tolerance: byte equality throughout.

- Against the reference MMseqs2 goldens of tests/golden/proteome (how they
  were made: tests/test_proteome.py; a 3-proteome toy), data file and
  index: `proteomecluster` equals `refaln` and `refcount`, with one
  Aligner.align_batch a round (proteome.STATS) where the JAX package calls
  align_query a cluster, and the same bytes in blocks of 2 clusters;
  `parseproteomealignments` equals `refpa`.
- Against the JAX package on the same inputs, where no golden exists:
  proteomecluster's protein records (--include-align-files), `pickrepprofile`
  and `pickconsensusrep` on the golden proteome toy, `easy-proteomecluster`
  and `easy-proteomesearch` on tests/test_easy_proteome.py's toy (records
  0-14 and 5-24 of the toy's QUERY.fasta), and the consensus switch of
  `cluster --cluster-version 2` and `linclust` on a seeded set of 12
  families of 6 (it moves 3 representatives); `-m slow` runs the switch on
  the whole toy (the JAX side takes about 3 minutes).
"""

import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.align.aligner import Aligner
from mmseqs2_tpu_torch.commands import proteome
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
PR = REPO / "tests" / "golden" / "proteome"
TOY = REPO / "tests" / "golden" / "toy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
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


def same_db(golden, ours):
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(golden).read_bytes()
    assert (pathlib.Path(f"{ours}.index").read_bytes()
            == pathlib.Path(f"{golden}.index").read_bytes())


def proteomecluster_args(out, *flags):
    return ["proteomecluster", PR / "pdb", PR / "clu", out / "aln",
            out / "count", out / "prot", "--threads", "1", *flags]


def test_proteomecluster(tmp_path, on_cpu, monkeypatch):
    """Both rounds (references protA, then protC) make one align_batch
    between them, as the second has no pair to align, and no align_query."""
    def refuse(*a, **k):
        raise AssertionError("align_query called")
    monkeypatch.setattr(Aligner, "align_query", refuse)
    proteome.reset_stats()
    run(proteomecluster_args(tmp_path))
    same_db(PR / "refaln", tmp_path / "aln")
    same_db(PR / "refcount", tmp_path / "count")
    st = proteome.STATS
    assert st["rounds"] == 2 and st["batches"] == 1
    assert st["clusters"] == 10 and st["pairs"] == 10


def test_proteomecluster_in_blocks(tmp_path, on_cpu, monkeypatch):
    """Blocks of 2 clusters: 5 align_batch calls, the same bytes."""
    monkeypatch.setattr(proteome, "BLOCK", 2)
    proteome.reset_stats()
    run(proteomecluster_args(tmp_path, "--include-align-files", "1"))
    same_db(PR / "refaln", tmp_path / "aln")
    same_db(PR / "refcount", tmp_path / "count")
    assert proteome.STATS["batches"] == 5


def test_proteomecluster_records_match_jax(tmp_path, on_cpu):
    """The protein records of --include-align-files (no golden)."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    run(proteomecluster_args(tmp_path / "p", "--include-align-files", "1"))
    run_jax(proteomecluster_args(tmp_path / "j", "--include-align-files",
                                 "1"))
    for name in ("prot", "aln", "count"):
        same_db(tmp_path / "j" / name, tmp_path / "p" / name)
    assert (tmp_path / "p" / "prot").read_bytes().count(b"\n") == 20


def test_parseproteomealignments(tmp_path, on_cpu):
    out = tmp_path / "pa"
    run(["parseproteomealignments", PR / "pdb", PR / "pdb", PR / "alnclu",
         out, "--threads", "1"])
    same_db(PR / "refpa", out)


def test_pickrepprofile_matches_jax(tmp_path, on_cpu):
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    args = [PR / "pdb", PR / "alnclu"]
    run(["pickrepprofile", *args, ours, "--threads", "1"])
    run_jax(["pickrepprofile", *args, theirs, "--threads", "1"])
    same_db(theirs, ours)


def test_pickconsensusrep_matches_jax(tmp_path, on_cpu):
    """result2msa, msa2profile and align of the profiles (sw_multi's plain
    version) against the members, then the rewrite."""
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    run(["pickconsensusrep", PR / "pdb", PR / "clu", ours, tmp_path / "t1",
         "--threads", "1"])
    run_jax(["pickconsensusrep", PR / "pdb", PR / "clu", theirs,
             tmp_path / "t2", "--threads", "1"])
    same_db(theirs, ours)


def proteome_fastas(tmp_path):
    """tests/test_easy_proteome.py's toy: two proteomes of 15 and 20 of the
    toy's records, 10 shared."""
    txt = (TOY / "QUERY.fasta").read_text()
    recs = [">" + r for r in txt.split(">") if r.strip()][:25]
    a, b = tmp_path / "protA.fasta", tmp_path / "protB.fasta"
    a.write_text("".join(recs[0:15]))
    b.write_text("".join(recs[5:25]))
    return a, b


def test_easy_proteomecluster_matches_jax(tmp_path, on_cpu):
    a, b = proteome_fastas(tmp_path)
    flags = ["--threads", "1", "--linclust-version", "1"]
    run(["easy-proteomecluster", a, b, tmp_path / "p", tmp_path / "t1",
         *flags])
    run_jax(["easy-proteomecluster", a, b, tmp_path / "j", tmp_path / "t2",
             *flags])
    for suffix in ("_protein_cluster.tsv", "_cluster_count.tsv",
                   "_proteome_cluster.tsv"):
        ours = (tmp_path / f"p{suffix}").read_bytes()
        assert ours and ours == (tmp_path / f"j{suffix}").read_bytes()


def test_easy_proteomesearch_matches_jax(tmp_path, on_cpu):
    a, b = proteome_fastas(tmp_path)
    run(["easy-proteomesearch", a, b, tmp_path / "p", tmp_path / "t1",
         "--threads", "1"])
    run_jax(["easy-proteomesearch", a, b, tmp_path / "j", tmp_path / "t2",
             "--threads", "1"])
    for suffix in (".tsv", "_search.m8"):
        ours = (tmp_path / f"p{suffix}").read_bytes()
        assert ours and ours == (tmp_path / f"j{suffix}").read_bytes()


def family_fasta(path, n_fam=12, members=6, seed=5):
    """n_fam families of mutated copies (5-25% substitutions, ends cut by
    up to 9 letters) of random sequences of 120-259 letters, shuffled."""
    rng = np.random.default_rng(seed)
    aa = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    recs = []
    for f in range(n_fam):
        n = int(rng.integers(120, 260))
        base = rng.integers(0, 20, n)
        for m in range(members):
            s = base.copy()
            mut = rng.random(n) < rng.uniform(0.05, 0.25)
            s[mut] = rng.integers(0, 20, int(mut.sum()))
            s = s[int(rng.integers(0, 10)): n - int(rng.integers(0, 10))]
            recs.append((f"fam{f}_{m}", "".join(aa[s])))
    with open(path, "w") as fh:
        for i in rng.permutation(len(recs)):
            fh.write(f">{recs[i][0]}\n{recs[i][1]}\n")


SWITCH = {
    "cluster": ["cluster", "{db}", "{out}", "{tmp}", "--cluster-version",
                "2", "--switch-consensus-rep", "1"],
    "linclust": ["linclust", "{db}", "{out}", "{tmp}", "--min-seq-id",
                 "0.5", "--switch-consensus-rep", "1"],
}


def switch_args(name, db, out, tmp):
    return [str(a).format(db=db, out=out, tmp=tmp) for a in SWITCH[name]]


@pytest.mark.parametrize("name", sorted(SWITCH))
def test_switch_consensus_rep_matches_jax(tmp_path, on_cpu, name):
    """pickconsensusrepfast over the clustering's alignments replaces the
    clustering, as in the JAX package; the alignments go."""
    family_fasta(tmp_path / "fam.fasta")
    db = tmp_path / "db"
    run(["createdb", tmp_path / "fam.fasta", db])
    run(switch_args(name, db, tmp_path / "p", tmp_path / "t1"))
    run_jax(switch_args(name, db, tmp_path / "j", tmp_path / "t2"))
    same_db(tmp_path / "j", tmp_path / "p")
    assert not (tmp_path / "p_aln.dbtype").exists()
    run(switch_args(name, db, tmp_path / "n", tmp_path / "t3")[:-2])
    reps = [pathlib.Path(f"{tmp_path / x}.index").read_text().split("\n")
            for x in ("p", "n")]
    assert len(reps[0]) == len(reps[1]) and reps[0] != reps[1]


@pytest.mark.slow
def test_switch_consensus_rep_on_the_toy(tmp_path, on_cpu):
    run(switch_args("cluster", TOY / "qdb", tmp_path / "p", tmp_path / "t1"))
    run_jax(switch_args("cluster", TOY / "qdb", tmp_path / "j",
                        tmp_path / "t2"))
    same_db(tmp_path / "j", tmp_path / "p")
