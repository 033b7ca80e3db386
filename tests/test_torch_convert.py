"""The port's format converters (`commands/convert_tools.py`: convertmsa,
convertprofiledb, tsv2exprofiledb), with the CPU requested, against the
reference MMseqs2 goldens of tests/golden/convert that test_convert.py
uses. Tolerance: byte equality, index files included.
"""

import pathlib
import shutil

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
G = REPO / "tests" / "golden" / "convert"


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


def db_bytes(path):
    return (pathlib.Path(path).read_bytes(),
            pathlib.Path(f"{path}.index").read_bytes())


@pytest.mark.parametrize("extra,gold", [([], "refmsa"),
                                        (["--identifier-field", 0],
                                         "refmsa0")])
def test_convertmsa(tmp_path, on_cpu, extra, gold):
    out = tmp_path / "msa"
    run(["convertmsa", G / "test.sto", out, *extra])
    assert db_bytes(out) == db_bytes(G / gold)


def test_convertprofiledb(tmp_path, on_cpu):
    out = tmp_path / "prof"
    run(["convertprofiledb", G / "hhmdb", out])
    assert db_bytes(out) == db_bytes(G / "refprof")
    assert db_bytes(f"{out}_h") == db_bytes(G / "refprof_h")
    assert (pathlib.Path(f"{out}.dbtype").read_bytes()
            == (G / "refprof.dbtype").read_bytes())


def test_tsv2exprofiledb(tmp_path, on_cpu):
    for suf in (".tsv", "_h.tsv", "_seq.tsv", "_aln.tsv"):
        shutil.copy(G / f"exin{suf}", tmp_path / f"exin{suf}")
    out = tmp_path / "ex"
    run(["tsv2exprofiledb", tmp_path / "exin", out])
    for suf in ("", "_aln", "_seq", "_seq_h"):
        assert db_bytes(f"{out}{suf}") == db_bytes(G / f"refex{suf}")


def test_convertmsa_then_msa2profile_matches_the_jax_package(tmp_path,
                                                              on_cpu):
    """The Stockholm file through convertmsa and msa2profile in both
    packages: the MSA DB and the profile DB equal byte for byte."""
    from mmseqs2_tpu import cli as jcli
    run(["convertmsa", G / "test.sto", tmp_path / "msa"])
    run(["msa2profile", tmp_path / "msa", tmp_path / "port"])
    assert jcli.main(["msa2profile", str(tmp_path / "msa"),
                      str(tmp_path / "jax")]) == 0
    for suf in ("", "_h"):
        assert db_bytes(f"{tmp_path / 'port'}{suf}") == \
            db_bytes(f"{tmp_path / 'jax'}{suf}")
