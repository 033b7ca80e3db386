"""The port's multihit commands (`commands/multihit.py` whole and
`commands/multihit_wf.py`: `besthitperset`, `combinepvalperset`,
`mergeresultsbyset`, `result2stats`, `multihitdb`, `multihitsearch`) with
the CPU requested. Tolerance: byte equality throughout.

- Against the reference MMseqs2 goldens of tests/golden/multihit (how they
  were made: tests/test_multihit.py), data file and index: `bhps`,
  `bhps_nonsimple`, `comb0-3`, `merged`, and `wf/refdb*` and `wf/refout`
  for the two workflows (multihitsearch runs the k-mer prefilter and align
  on the translated ORFs: the plain versions of diag_rescore and sw_multi
  here).
- Against the JAX package on the same inputs, where no golden exists:
  `result2stats`, each statistic.
"""

import pathlib

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
MH = REPO / "tests" / "golden" / "multihit"
WF = MH / "wf"
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


@pytest.mark.parametrize("flags,gold", [
    ([], "bhps"), (["--simple-best-hit", "0"], "bhps_nonsimple")])
def test_besthitperset(tmp_path, on_cpu, flags, gold):
    out = tmp_path / "o"
    run(["besthitperset", MH / "qdb", MH / "tdb", MH / "res", out, *flags])
    same_db(MH / gold, out)


def test_mergeresultsbyset_of_besthits(tmp_path, on_cpu):
    out = tmp_path / "o"
    run(["mergeresultsbyset", MH / "qdb_set_to_member", MH / "bhps", out])
    same_db(MH / "merged", out)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_combinepvalperset(tmp_path, on_cpu, mode):
    out = tmp_path / "o"
    run(["combinepvalperset", MH / "qdb", MH / "tdb", MH / "merged", out,
         "--aggregation-mode", mode])
    same_db(MH / f"comb{mode}", out)


# (statistic, result DB, target DB): the value statistics read the first
# column of the result lines (bhps' column 1 is a number), the sequence
# statistics look the result's keys up in the target DB
RESULT2STATS = [
    ("linecount", TOY / "aln", TOY / "qdb"),
    ("mean", MH / "bhps", MH / "tdb"),
    ("min", MH / "bhps", MH / "tdb"),
    ("max", MH / "bhps", MH / "tdb"),
    ("sum", MH / "bhps", MH / "tdb"),
    ("firstline", TOY / "aln", TOY / "qdb"),
    ("doolittle", TOY / "aln", TOY / "qdb"),
    ("charges", TOY / "aln", TOY / "qdb"),
    ("seqlen", TOY / "aln", TOY / "qdb"),
    ("strlen", TOY / "aln", TOY / "qdb"),
]


@pytest.mark.parametrize("stat,res,tdb", RESULT2STATS,
                         ids=[s[0] for s in RESULT2STATS])
def test_result2stats_matches_jax(tmp_path, on_cpu, stat, res, tdb):
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    run(["result2stats", tdb, tdb, res, ours, "--stat", stat])
    run_jax(["result2stats", tdb, tdb, res, theirs, "--stat", stat])
    same_db(theirs, ours)
    assert pathlib.Path(ours).stat().st_size > 0


def test_multihit_workflows(tmp_path, on_cpu):
    """multihitdb of the contigs (createdb, tsv2db, extractorfs,
    translatenucs, orftocontig, filterdb, swapdb, result2stats), then
    multihitsearch of the set DB against itself (search, besthitperset,
    mergeresultsbyset): every DB equal to the golden."""
    db = tmp_path / "mydb"
    run(["multihitdb", WF / "contigs.fasta", db, tmp_path / "t1"])
    for suffix in ("", "_member_to_set", "_set_to_member", "_set_size",
                   "_nucl_contig_to_set"):
        same_db(WF / f"refdb{suffix}", f"{db}{suffix}")
    out = tmp_path / "out"
    run(["multihitsearch", db, db, out, tmp_path / "t2"])
    same_db(WF / "refout", out)
