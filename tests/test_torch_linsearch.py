"""The port's linsearch commands (`commands/linsearch.py`: `kmerindexdb`,
`createlinindex`, `kmersearch`, `linsearch`, `easy-linsearch`) with the CPU
requested. Tolerance: byte equality throughout.

- Against the reference MMseqs2 golden of tests/golden/linsearch (how it
  was made: tests/test_linsearch.py), data file and index: `linsearch`
  (kmersearch, rescorediagonal, filterdb, align through sw_multi's plain
  version here, swapresults) equals `reflin`; the `.linidx` index that
  `kmerindexdb` and `createlinindex` write equals `bdb.linidx` (data,
  index and dbtype).
- Against the JAX package on the same inputs: `kmersearch` of both result
  directions; `easy-linsearch`'s m8 equals the port's `convertalis` of
  the golden.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands.linsearch import load_linidx
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
LS = REPO / "tests" / "golden" / "linsearch"


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


def same_db(golden, ours, suffixes=("", ".index")):
    for suf in suffixes:
        assert (pathlib.Path(f"{ours}{suf}").read_bytes()
                == pathlib.Path(f"{golden}{suf}").read_bytes()), suf


def copy_bdb(tmp_path):
    """The target DB in a directory of its own: linsearch and
    createlinindex write <target>.linidx beside it."""
    tdb = tmp_path / "bdb"
    for suf in ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype"):
        shutil.copy(LS / f"bdb{suf}", f"{tdb}{suf}")
    return tdb


def test_linsearch(tmp_path, on_cpu):
    tdb = copy_bdb(tmp_path)
    out = tmp_path / "lin"
    run(["linsearch", LS / "adb", tdb, out, tmp_path / "t"])
    same_db(LS / "reflin", out)
    same_db(LS / "bdb.linidx", f"{tdb}.linidx",
            ("", ".index", ".dbtype"))


def test_kmerindexdb_roundtrip(tmp_path, on_cpu):
    idx = tmp_path / "idx"
    run(["kmerindexdb", LS / "bdb", idx])
    same_db(LS / "bdb.linidx", idx, ("", ".index", ".dbtype"))
    meta, kmer, sid, pos, slen = load_linidx(str(idx))
    # one entry per distinct k-mer, ascending
    assert meta["n_entries"] == len(kmer) > 0
    assert np.all(kmer[1:] > kmer[:-1])


def test_createlinindex(tmp_path, on_cpu):
    tdb = copy_bdb(tmp_path)
    run(["createlinindex", tdb])
    same_db(LS / "bdb.linidx", f"{tdb}.linidx", ("", ".index", ".dbtype"))


@pytest.mark.parametrize("direction", [0, 1])
def test_kmersearch_matches_jax(tmp_path, on_cpu, direction):
    from mmseqs2_tpu import cli as jcli
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    run(["kmersearch", LS / "adb", LS / "bdb.linidx", ours,
         "--result-direction", direction])
    assert jcli.main(["kmersearch", str(LS / "adb"),
                      str(LS / "bdb.linidx"), str(theirs),
                      "--result-direction", str(direction)]) == 0
    same_db(theirs, ours)
    assert ours.stat().st_size > 0


def test_easy_linsearch(tmp_path, on_cpu):
    tdb = copy_bdb(tmp_path)
    out = tmp_path / "lin.m8"
    run(["easy-linsearch", LS / "adb", tdb, out, tmp_path / "t"])
    want = tmp_path / "want.m8"
    run(["convertalis", LS / "adb", tdb, LS / "reflin", want])
    assert out.read_bytes() == want.read_bytes() and out.stat().st_size
