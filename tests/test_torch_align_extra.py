"""The port's alignment extras (`alignall`, `transitivealign`, `pairaln`,
`alignbykmer`) with the CPU requested, against the reference MMseqs2
goldens of tests/golden/alignx and tests/golden/pairaln (how they were made:
tests/test_pairaln.py), byte for byte: data file and index. alignall runs
its member pairs through Aligner.align_batch (the `sw_multi` kernel's plain
version here)."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import align_extra
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.params import Params

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
AX = GOLDEN / "alignx"
PAIR = GOLDEN / "pairaln"
TOY = GOLDEN / "toy"
NUCL = GOLDEN / "nucl"


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


def params(files, **kw):
    p = Params()
    p.filenames = [str(f) for f in files]
    for k, v in kw.items():
        p.set(k, v)
    return p


def same_db(golden, ours):
    assert pathlib.Path(golden).read_bytes() == pathlib.Path(ours).read_bytes()
    assert (pathlib.Path(f"{golden}.index").read_bytes()
            == pathlib.Path(f"{ours}.index").read_bytes())


def test_alignall(tmp_path, on_cpu, monkeypatch):
    """alignall qdb clu0 allaln -a: a block budget that cuts the 420 sets
    into several align_batch calls gives the golden's bytes."""
    monkeypatch.setattr(align_extra, "ALIGNALL_PAIRS", 300)
    align_extra.reset_stats()
    out = tmp_path / "allaln"
    align_extra.alignall(params([TOY / "qdb", TOY / "clu0", out],
                                add_backtrace=True), None)
    same_db(AX / "allaln", out)
    st = align_extra.STATS
    assert st["sets"] == 420 and st["batches"] >= 3 and st["pairs"] > 300


def test_transitivealign(tmp_path, on_cpu):
    out = tmp_path / "transaln"
    align_extra.transitivealign(params([TOY / "qdb", TOY / "aln", out]),
                                None)
    same_db(AX / "transaln", out)


@pytest.mark.parametrize("name,dbs", [
    ("abk", (TOY / "qdb", TOY / "qdb", TOY / "pref")),
    ("nabk", (NUCL / "ndb", NUCL / "ndb", AX / "nprefx"))])
def test_alignbykmer(tmp_path, on_cpu, name, dbs):
    """Amino acids (abk) and nucleotides (nabk)."""
    out = tmp_path / name
    align_extra.alignbykmer(params([*dbs, out]), None)
    same_db(AX / name, out)


PAIR_CASES = [
    ("ptop", {}),
    ("ptopd", {"pairdummymode": 1}),
    ("pprox", {"pairfilter": 1}),
    ("pprox2", {"pairfilter": 1,
                "pair_proximity_distance": 900000000000000000}),
    ("pproxall2", {"pairfilter": 1, "pairmode": 1, "pairdummymode": 1,
                   "pair_proximity_distance": 900000000000000000}),
]


@pytest.mark.parametrize("name,kw", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_pairaln(tmp_path, on_cpu, name, kw):
    out = tmp_path / name
    align_extra.pairaln(
        params([PAIR / "pairq", PAIR / "tdb", PAIR / "aln", out], **kw), None)
    same_db(PAIR / name, out)


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
ax, toy, pair, out, sets = sys.argv[1:6]
assert main(["alignall", toy + "/qdb", sets, out + "_all", "-a"]) == 0
assert main(["alignbykmer", toy + "/qdb", toy + "/qdb", toy + "/pref",
             out + "_abk"]) == 0
assert main(["transitivealign", toy + "/qdb", toy + "/aln",
             out + "_trans"]) == 0
assert main(["pairaln", pair + "/pairq", pair + "/tdb", pair + "/aln",
             out + "_ptop"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_commands_run_from_the_cli_without_jax(tmp_path):
    """Through `python -m mmseqs2_tpu_torch`'s entry point, in a process of
    its own: neither jax nor the JAX package is loaded, and the outputs are
    the goldens'."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    out = tmp_path / "out"
    # alignall of ten sets: an entry depends on its set alone
    sets = str(tmp_path / "sets")
    with DBReader(str(TOY / "clu0")) as r, \
            DBWriter(sets, r.base_type, r.extended_type) as w:
        keys = [r.get_db_key(i) for i in range(10)]
        for k in keys:
            w.write(k, r.get_data(r.get_id(k)))
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(AX),
                        str(TOY), str(PAIR), str(out), sets], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    with DBReader(f"{out}_all") as a, DBReader(str(AX / "allaln")) as g:
        assert [a.get_data(a.get_id(k)) for k in keys] == \
            [g.get_data(g.get_id(k)) for k in keys]
    same_db(AX / "abk", f"{out}_abk")
    same_db(AX / "transaln", f"{out}_trans")
    same_db(PAIR / "ptop", f"{out}_ptop")


def test_the_commands_are_registered_with_the_jax_usage(capsys):
    from mmseqs2_tpu.registry import get_command as jax_command
    from mmseqs2_tpu_torch.registry import get_command
    for name in ("alignall", "transitivealign", "pairaln", "alignbykmer",
                 "fwbw"):
        mine, theirs = get_command(name), jax_command(name)
        assert (mine.usage, mine.min_db, mine.max_db) == \
            (theirs.usage, theirs.min_db, theirs.max_db), name
        assert cli.main([name, "--help"]) == 0
        assert mine.usage in capsys.readouterr().out
