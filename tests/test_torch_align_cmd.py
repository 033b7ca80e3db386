"""The port's CLI (`python -m mmseqs2_tpu_torch`) against the reference
MMseqs2 goldens of tests/golden/toy, with the CPU requested: createdb must be
byte-identical and align entry-identical. Also: the port never loads JAX or
the JAX package, and without a CUDA card it runs only when asked to use the
CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
N_SUBSET = 40


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


def pref_subset(tmp_path, keys):
    """The golden prefilter DB restricted to the given queries."""
    golden = entries_by_key(GOLDEN / "pref")
    out = tmp_path / "prefsub"
    with DBWriter(str(out), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in keys:
            w.write(k, golden[k])
    return out


def test_createdb_byte_parity(tmp_path, on_cpu):
    out = tmp_path / "qdb"
    run(["createdb", GOLDEN / "QUERY.fasta", out])
    for suffix in ("", ".index", ".dbtype", ".lookup", ".source", "_h",
                   "_h.index", "_h.dbtype"):
        got = pathlib.Path(f"{out}{suffix}").read_bytes()
        want = pathlib.Path(f"{GOLDEN / 'qdb'}{suffix}").read_bytes()
        assert got == want, f"mismatch in qdb{suffix}"


@pytest.mark.parametrize("extra,gold", [
    (["-a"], "aln"),
    (["--sub-mat", "blosum62.out", "--gap-open", "13", "--gap-extend", "2"],
     "aln_blosum62_13_2"),
])
def test_align_parity(tmp_path, on_cpu, extra, gold):
    keys = list(range(N_SUBSET))
    out = tmp_path / "aln"
    run(["align", GOLDEN / "qdb", GOLDEN / "qdb", pref_subset(tmp_path, keys),
         out, *extra])
    got = entries_by_key(out)
    want = entries_by_key(GOLDEN / gold)
    assert sorted(got) == keys
    for k in keys:
        assert got[k] == want[k], f"query {k}:\n{got[k]!r}\n!=\n{want[k]!r}"


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
golden, tmp = sys.argv[1], sys.argv[2]
assert main(["createdb", golden + "/QUERY.fasta", tmp + "/qdb"]) == 0
with DBReader(golden + "/pref") as r, \\
        DBWriter(tmp + "/pref", dbt.DBTYPE_PREFILTER_RES) as w:
    for i in range(4):
        w.write(r.get_db_key(i), r.get_data(i))
assert main(["align", tmp + "/qdb", tmp + "/qdb", tmp + "/pref",
             tmp + "/aln", "-a"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_cli_loads_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(GOLDEN),
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert entries_by_key(tmp_path / "aln")


def test_entry_point_needs_cuda_or_cpu_request(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["createdb", str(GOLDEN / "QUERY.fasta"),
                  str(tmp_path / "qdb")])
    assert not (tmp_path / "qdb").exists()


def test_unported_paths_say_so(tmp_path, on_cpu, capsys):
    assert cli.main(["rbh", "a", "b", "c", "d"]) == 1
    assert "not yet ported" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(["linclust", str(GOLDEN / "qdb"), str(tmp_path / "clu"),
                  str(tmp_path / "tmp"), "--switch-consensus-rep", "1"])


ALT = REPO / "tests" / "golden" / "alt"


def test_alt_alignments_parity(tmp_path, on_cpu):
    """--alt-ali 2: primary hit plus two X-masked realignments."""
    out = tmp_path / "aln"
    run(["align", ALT / "qd", ALT / "td", ALT / "pf", out, "-a",
         "--alt-ali", "2", "--threads", "1", "-e", "1e5"])
    assert out.read_bytes() == (ALT / "refalt2").read_bytes()


def test_corr_score_weight_parity(tmp_path, on_cpu):
    out = tmp_path / "aln"
    run(["align", ALT / "q8", GOLDEN / "qdb", ALT / "prefsub", out, "-a",
         "--corr-score-weight", "0.1", "--threads", "1", "-e", "10"])
    assert entries_by_key(out) == entries_by_key(ALT / "refcorr")


def test_realign_parity(tmp_path, on_cpu):
    """--realign (score-only first pass, boundaries recomputed with the
    -0.2-biased matrix) on the first queries of the golden's input."""
    golden = entries_by_key(GOLDEN / "it_pref_0")
    keys = sorted(golden)[:N_SUBSET]
    pref = tmp_path / "pref"
    with DBWriter(str(pref), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in keys:
            w.write(k, golden[k])
    out = tmp_path / "aln"
    run(["align", GOLDEN / "qdb", GOLDEN / "qdb", pref, out, "-a", "1",
         "--realign", "1", "-e", "0.001"])
    want = entries_by_key(GOLDEN / "it_aln_0")
    got = entries_by_key(out)
    assert sorted(got) == keys
    for k in keys:
        assert got[k] == want[k], f"query {k}"
