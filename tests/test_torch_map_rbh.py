"""The port's map and reciprocal-best-hit workflows (`commands/map_rbh.py`:
`map`, `rbh`, `easy-rbh`, `result2rbh`) with the CPU requested. Tolerance:
byte equality throughout.

- Against the reference MMseqs2 goldens of tests/golden/maprbh (how they
  were made: tests/test_maprbh.py), data file and index: `map` (search at
  --alignment-mode 4, so its align step is rescorediagonal after the k-mer
  prefilter) equals `refmap`, `rbh` (two searches: the prefilter and
  sw_multi's plain versions here) `refrbh2`.
- `easy-rbh` of the same DBs: its result DB equals `refrbh2` and its m8
  the port's `convertalis` of the golden.
- `result2rbh` against the JAX package on the same input.
- From the shell, the 21 commands of the slice answer `--help`, and `map`
  runs without loading `jax` or `mmseqs2_tpu`.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
MR = REPO / "tests" / "golden" / "maprbh"
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


def same_db(golden, ours):
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(golden).read_bytes()
    assert (pathlib.Path(f"{ours}.index").read_bytes()
            == pathlib.Path(f"{golden}.index").read_bytes())


def test_map(tmp_path, on_cpu):
    out = tmp_path / "map"
    run(["map", MR / "adb", MR / "bdb", out, tmp_path / "t"])
    same_db(MR / "refmap", out)


def test_rbh(tmp_path, on_cpu):
    out = tmp_path / "rbh"
    run(["rbh", MR / "adb", MR / "bdb", out, tmp_path / "t"])
    same_db(MR / "refrbh2", out)


def test_easy_rbh(tmp_path, on_cpu):
    """easy-rbh takes DBs as they are (no createdb): the workflow's result
    DB is the golden's, and its m8 the golden converted."""
    out = tmp_path / "rbh.m8"
    tmp = tmp_path / "t"
    run(["easy-rbh", MR / "adb", MR / "bdb", out, tmp,
         "--remove-tmp-files", "0"])
    results = [p for p in tmp.rglob("result.dbtype")]
    assert len(results) == 1
    same_db(MR / "refrbh2", str(results[0])[: -len(".dbtype")])
    want = tmp_path / "want.m8"
    run(["convertalis", MR / "adb", MR / "bdb", MR / "refrbh2", want])
    assert out.read_bytes() == want.read_bytes() and out.stat().st_size


def test_result2rbh_matches_jax(tmp_path, on_cpu):
    """result2rbh of the toy's alignments (lines of equal bit score after
    each entry's first one) as the JAX package writes it."""
    from mmseqs2_tpu import cli as jcli
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    run(["result2rbh", TOY / "aln", ours])
    assert jcli.main(["result2rbh", str(TOY / "aln"), str(theirs)]) == 0
    same_db(theirs, ours)
    assert ours.read_bytes().count(b"\n") > 0


# the slice's commands: `--help` of each, then `map` of the golden DBs, as
# `python -m mmseqs2_tpu_torch` runs them, and the modules they loaded
SLICE_COMMANDS = (
    "besthitperset", "combinepvalperset", "result2stats", "multihitdb",
    "multihitsearch", "map", "rbh", "easy-rbh", "result2rbh", "kmerindexdb",
    "createlinindex", "kmersearch", "linsearch", "easy-linsearch",
    "proteomecluster", "parseproteomealignments", "pickrepprofile",
    "pickconsensusrep", "pickconsensusrepfast", "easy-proteomecluster",
    "easy-proteomesearch")

SUBPROCESS_RUN = r"""
import sys
from mmseqs2_tpu_torch import cli
names, mr, tmp = sys.argv[1].split(","), sys.argv[2], sys.argv[3]
for name in names:
    assert cli.main([name, "--help"]) == 0, name
assert cli.main(["map", mr + "/adb", mr + "/bdb", tmp + "/map",
                 tmp + "/t"]) == 0
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "mmseqs2_tpu")))
"""


def test_cli_runs_the_slice_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN,
                        ",".join(SLICE_COMMANDS), str(MR), str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    for name in SLICE_COMMANDS:
        assert f"python -m mmseqs2_tpu_torch {name} " in r.stdout, name
    same_db(MR / "refmap", tmp_path / "map")
