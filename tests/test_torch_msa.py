"""The port's MSA path and MSA/profile tools (`commands/msa_tools.py`,
`commands/expandaln.py`, `profile/msa.py:compute_msa_del`,
`profile/ca3m.py`, `enrich`), with the CPU requested. Tolerance: byte
equality throughout.

- Against the reference MMseqs2 goldens that the JAX package's tests use:
  `golden/toy/util` (result2msa, msa2profile, profile2pssm,
  profile2consensus, profile2repseq: test_parity_toy.py), the toy's
  expandaln goldens (`exp_aln`, `exp_aln_rescore`, `efc/refefc`,
  `exp_prof`), `golden/msares` (filtera3m, msa2result), `golden/msadel`
  (result2msa --allow-deletion), `golden/domain/convca3m` and
  `golden/dbops/neff.txt`.
- Against the JAX package's commands on the same inputs, where no golden
  exists: result2msa of a result DB whose backtraces were stripped (the
  realignment: blocked Aligner.align_batch here, align_query a query
  there) and `enrich` (slow).
- A subprocess runs the 16 commands of this slice from the CLI and checks
  that neither `jax` nor `mmseqs2_tpu` was loaded.

JAX is imported inside the tests that compare with it.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import msa_tools
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.profile.ca3m import hit_to_buffer

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
TOY = GOLDEN / "toy"
UTIL = TOY / "util"
# toy queries with many alignment hits (golden/toy/aln)
RICH = (99, 219, 52, 367, 243, 235)


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
    return tuple(pathlib.Path(f"{path}{suf}").read_bytes()
                 for suf in ("", ".index", ".dbtype"))


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def sub_results(src, keys, dst, strip=False):
    """Result DB of `src`'s entries for `keys`; strip=True drops each line's
    backtrace column (the first ten columns stay)."""
    with DBReader(str(src)) as r, \
            DBWriter(str(dst), dbt.DBTYPE_ALIGNMENT_RES) as w:
        for k in keys:
            data = r.get_data(r.get_id(k))
            if strip:
                data = b"".join(b"\t".join(line.split(b"\t")[:10]) + b"\n"
                                for line in data.split(b"\n") if line)
            w.write(k, data)
    return dst


def expand_cigar(bt):
    out, num = [], ""
    for c in bt:
        if c.isdigit():
            num += c
        else:
            out.append(c * int(num))
            num = ""
    return "".join(out)


def build_ca3m(base):
    """The ca3m triple that made golden/domain's convca3m (as
    test_domain_tools.py builds it): a query's consensus head, its self
    record and one record a golden/toy/aln hit, encoded with the port's
    hit_to_buffer."""
    with DBReader(str(TOY / "qdb")) as qdb, DBReader(str(TOY / "aln")) as aln, \
            open(f"{base}_ca3m.ffdata", "wb") as data, \
            open(f"{base}_ca3m.ffindex", "w") as idx:
        off = 0
        for i in range(aln.size):
            key = aln.get_db_key(i)
            qi = qdb.get_id(key)
            qseq = qdb.get_seq(qi).decode()
            entry = bytearray(f">consensus_q{key}\n{qseq}\n;".encode())
            entry += hit_to_buffer(qi, 0, 0, "M" * len(qseq))
            for line in aln.get_data(i).decode().splitlines():
                f = line.split("\t")
                entry += hit_to_buffer(
                    qdb.get_id(int(f[0])), int(f[4]), int(f[7]),
                    expand_cigar(f[10]) if len(f) > 10 else "")
            entry += b"\0"
            data.write(entry)
            idx.write(f"{key}\t{off}\t{len(entry)}\n")
            off += len(entry)
    for src, dst in (("qdb", "_sequence.ffdata"), ("qdb.index",
                                                   "_sequence.ffindex"),
                     ("qdb_h", "_header.ffdata"),
                     ("qdb_h.index", "_header.ffindex")):
        shutil.copy(TOY / src, f"{base}{dst}")
    return base


# -- result2msa and msa2profile (test_parity_toy.py:411-433) ---------------


@pytest.mark.parametrize("extra,gold", [([], "refmsa"),
                                        (["--msa-format-mode", 5], "refa3m")])
def test_result2msa_parity(tmp_path, on_cpu, extra, gold):
    out = tmp_path / "msa"
    run(["result2msa", TOY / "qdb", TOY / "qdb", TOY / "it_aln_0", out,
         *extra])
    assert db_bytes(out)[:2] == db_bytes(UTIL / gold)[:2]


def first_entries(src, n, dst, dbtype):
    """A DB of `src`'s first n entries in data-file order (the order the
    commands read them in), written in that order."""
    with DBReader(str(src)) as r, DBWriter(str(dst), dbtype) as w:
        for i in list(r.linear_order())[:n]:
            w.write(r.get_db_key(int(i)), r.get_data(int(i)))
    return dst


@pytest.mark.parametrize("mode,gold", [(0, "refm2p"), (1, "refm2p1")])
def test_msa2profile_parity(tmp_path, on_cpu, mode, gold):
    """The first 32 MSAs of refmsa (a cut for time: all 500 take about 35 s
    on one core, the profile stack's host code; the slow test below runs
    them), each profile against the golden's entry."""
    msa = first_entries(UTIL / "refmsa", 32, tmp_path / "msa32",
                        dbt.DBTYPE_MSA_DB)
    out = tmp_path / "prof"
    run(["msa2profile", msa, out, "--match-mode", mode])
    got, want = entries_by_key(out), entries_by_key(UTIL / gold)
    assert len(got) == 32 and got == {k: want[k] for k in got}


@pytest.mark.slow
@pytest.mark.parametrize("mode,gold", [(0, "refm2p"), (1, "refm2p1")])
def test_msa2profile_parity_all(tmp_path, on_cpu, mode, gold):
    out = tmp_path / "prof"
    run(["msa2profile", UTIL / "refmsa", out, "--match-mode", mode])
    assert db_bytes(out) == db_bytes(UTIL / gold)


def test_profile2pssm_parity(tmp_path, on_cpu):
    out = tmp_path / "pssm.tsv"
    run(["profile2pssm", TOY / "it_profile_0", out])
    assert out.read_bytes() == (UTIL / "refpssm.tsv").read_bytes()


@pytest.mark.parametrize("cmd,gold", [("profile2consensus", "refcons"),
                                      ("profile2repseq", "refrep")])
def test_profile2seq_parity(tmp_path, on_cpu, cmd, gold):
    out = tmp_path / "seq"
    run([cmd, TOY / "it_profile_0", out])
    assert db_bytes(out) == db_bytes(UTIL / gold)


# -- the realignment: hits without a backtrace --------------------------------


def realign_run(tmp_path, monkeypatch, block, mode=2, name="port"):
    """result2msa of three RICH queries' toy alignments with their
    backtraces stripped (every hit but the query's own aligned again) in
    blocks of `block` queries; returns (the stats, the hits, the sw_multi
    calls: the CPU's plain version stands for the kernel)."""
    from mmseqs2_tpu_torch.align import aligner
    res = sub_results(TOY / "aln", RICH[:3], tmp_path / "strip", strip=True)
    calls = []
    plain = aligner.sw_multi

    def counted(*a, **kw):
        calls.append(a[1].shape[1])
        return plain(*a, **kw)
    monkeypatch.setattr(aligner, "sw_multi", counted)
    monkeypatch.setattr(msa_tools, "BLOCK", block)
    msa_tools.reset_stats()
    run(["result2msa", TOY / "qdb", TOY / "qdb", res, tmp_path / name,
         "--msa-format-mode", mode])
    monkeypatch.setattr(aligner, "sw_multi", plain)
    n_hits = sum(e.count(b"\n") for e in entries_by_key(res).values())
    return dict(msa_tools.STATS), n_hits, calls


@pytest.mark.parametrize("mode", [
    pytest.param(2, marks=pytest.mark.slow), 6])
def test_result2msa_realign_matches_the_jax_package(tmp_path, on_cpu,
                                                    monkeypatch, mode):
    """Three toy queries' alignments with their backtraces stripped:
    result2msa aligns every hit again, the port in blocks (2 queries here:
    two align_batch calls), the JAX package with align_query a query.
    a3m with the alignment columns (6; FASTA, 2, is slow: the JAX side's
    compilation takes most of the 12 s): bytes equal."""
    st, n_hits, calls = realign_run(tmp_path, monkeypatch, 2, mode)
    # the query's own hit is skipped (same DB), every other one realigned
    assert st["pairs"] == n_hits - 3 > 0
    assert st["queries"] == 3 and st["batches"] == 2
    assert st["readbacks"] == len(calls) > 0
    run_jax(["result2msa", TOY / "qdb", TOY / "qdb", tmp_path / "strip",
             tmp_path / "jax", "--msa-format-mode", mode])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")


def test_result2msa_realigns_a_block_in_one_batch(tmp_path, on_cpu,
                                                  monkeypatch):
    """One block of the three queries launches fewer scans than one
    align_batch a query (what align_query a query costs), for the same
    bytes."""
    one, _, calls_one = realign_run(tmp_path, monkeypatch, 3, name="one")
    each, _, calls_each = realign_run(tmp_path, monkeypatch, 1, name="each")
    assert (one["batches"], each["batches"]) == (1, 3)
    assert one["pairs"] == each["pairs"]
    assert len(calls_one) < len(calls_each)
    assert sum(calls_one) == sum(calls_each)     # the same lanes
    assert db_bytes(tmp_path / "one") == db_bytes(tmp_path / "each")


# -- expandaln (test_parity_toy.py:466-506) -----------------------------------


@pytest.mark.parametrize("extra,gold", [
    (["--expansion-mode", 0], TOY / "exp_aln"),
    (["--expansion-mode", 1], TOY / "exp_aln_rescore"),
    (["--expand-filter-clusters", 1], GOLDEN / "efc" / "refefc")])
def test_expandaln_parity(tmp_path, on_cpu, extra, gold):
    out = tmp_path / "exp"
    run(["expandaln", TOY / "qdb", TOY / "qdb", TOY / "aln", TOY / "aln",
         out, *extra])
    assert entries_by_key(out) == entries_by_key(gold)


def test_expand2profile_parity(tmp_path, on_cpu):
    """The first 32 queries' profiles (a cut for time: the whole toy set
    takes about 40 s on one core; test_expand2profile_parity_all is the
    slow test of all 500), each against the golden's entry."""
    keys = sorted(entries_by_key(TOY / "aln"))[:32]
    res = sub_results(TOY / "aln", keys, tmp_path / "aln32")
    out = tmp_path / "exprof"
    run(["expand2profile", TOY / "qdb", TOY / "qdb", res, TOY / "aln", out])
    want = entries_by_key(TOY / "exp_prof")
    assert entries_by_key(out) == {k: want[k] for k in keys}


@pytest.mark.slow
def test_expand2profile_parity_all(tmp_path, on_cpu):
    out = tmp_path / "exprof"
    run(["expand2profile", TOY / "qdb", TOY / "qdb", TOY / "aln",
         TOY / "aln", out])
    assert entries_by_key(out) == entries_by_key(TOY / "exp_prof")


# -- msares, msadel, domain, dbops ----------------------------------------------


def test_filtera3m_parity(tmp_path, on_cpu):
    out = tmp_path / "filt.a3m"
    run(["filtera3m", GOLDEN / "msares" / "big.a3m", out,
         "--max-seq-id", 0.9, "--diff", 5])
    assert out.read_bytes() == (GOLDEN / "msares" / "bigfilt.a3m").read_bytes()


def test_msa2result_matches_the_jax_package(tmp_path, on_cpu):
    """result2msa of the first 32 of the toy's alignment entries, then
    msa2result in both packages: bytes equal. (The golden needs all 500
    MSAs, whose count is the E-value's DB size: the slow test below.)"""
    keys = sorted(entries_by_key(TOY / "aln"))[:32]
    msa = tmp_path / "msa"
    run(["result2msa", TOY / "qdb", TOY / "qdb",
         sub_results(TOY / "aln", keys, tmp_path / "aln32"), msa])
    for name, fn in (("port", run), ("jax", run_jax)):
        fn(["msa2result", msa, tmp_path / f"{name}_seq",
            tmp_path / f"{name}_res", "--match-mode", 1])
    for suf in ("_res", "_seq", "_seq_h"):
        assert db_bytes(tmp_path / f"port{suf}") == \
            db_bytes(tmp_path / f"jax{suf}")
    assert entries_by_key(tmp_path / "port_res")


@pytest.mark.slow
def test_msa2result_parity(tmp_path, on_cpu):
    """All 500 MSAs (about 30 s on one core) against the golden."""
    msa = tmp_path / "msa"
    run(["result2msa", TOY / "qdb", TOY / "qdb", TOY / "aln", msa])
    seq, res = tmp_path / "m2r_seq", tmp_path / "m2r_res"
    run(["msa2result", msa, seq, res, "--match-mode", 1])
    g = GOLDEN / "msares"
    assert db_bytes(res)[:2] == db_bytes(g / "m2r_res")[:2]
    assert db_bytes(seq)[:2] == db_bytes(g / "m2r_seq")[:2]
    assert db_bytes(f"{seq}_h")[:2] == db_bytes(g / "m2r_seq_h")[:2]


@pytest.mark.parametrize("mode,gold", [(2, "refdeld"), (5, "refdeld5")])
def test_allow_deletion_parity(tmp_path, on_cpu, mode, gold):
    g = GOLDEN / "msadel"
    out = tmp_path / "msa"
    run(["result2msa", g / "dqd", g / "dtd", g / "daln", out,
         "--msa-format-mode", mode, "--allow-deletion"])
    assert out.read_bytes() == (g / gold).read_bytes()


def test_compute_msa_del_matches_the_jax_package():
    """compute_msa_del on the msadel goldens' alignments, row for row."""
    import numpy as np
    from mmseqs2_tpu.profile import msa as jmsa
    from mmseqs2_tpu_torch.profile import msa as tmsa
    from mmseqs2_tpu_torch.commands.convertalis import expand_cigar as ec

    class Hit:
        pass
    g = GOLDEN / "msadel"
    with DBReader(str(g / "dqd")) as q, DBReader(str(g / "dtd")) as t, \
            DBReader(str(g / "daln")) as a:
        for i in range(a.size):
            qn = np.frombuffer(q.get_seq(q.get_id(a.get_db_key(i))),
                               np.uint8) % 21
            seqs, alns = [], []
            for line in a.get_data(i).decode().splitlines():
                f = line.split("\t")
                h = Hit()
                h.q_start, h.db_start = int(f[4]), int(f[7])
                h.backtrace = ec(f[10])
                alns.append(h)
                seqs.append(np.frombuffer(t.get_seq(t.get_id(int(f[0]))),
                                          np.uint8) % 21)
            assert "D" in "".join(h.backtrace for h in alns)
            np.testing.assert_array_equal(
                tmsa.compute_msa_del(qn, seqs, alns),
                jmsa.compute_msa_del(qn, seqs, alns))


def test_convertca3m_parity(tmp_path, on_cpu):
    base = build_ca3m(tmp_path / "ca3m")
    out = tmp_path / "convca3m"
    run(["convertca3m", base, out])
    assert db_bytes(out)[:2] == db_bytes(GOLDEN / "domain" / "convca3m")[:2]


def test_ca3m_codec_matches_the_jax_package(tmp_path):
    """The port's ca3m triple is the JAX package's byte for byte, and both
    decoders give the same A3M text and hit records."""
    from mmseqs2_tpu.profile import ca3m as jca3m
    from mmseqs2_tpu_torch.profile import ca3m as tca3m
    base = build_ca3m(tmp_path / "ca3m")
    for qi, bt in ((3, "MMIIDM" * 9), (0, "M" * 40)):
        assert tca3m.hit_to_buffer(qi, 2, 5, bt) == \
            jca3m.hit_to_buffer(qi, 2, 5, bt)
    with DBReader(f"{base}_ca3m.ffdata", f"{base}_ca3m.ffindex") as r, \
            DBReader(f"{base}_sequence.ffdata",
                     f"{base}_sequence.ffindex") as s, \
            DBReader(f"{base}_header.ffdata",
                     f"{base}_header.ffindex") as h:
        for i in (0, 1, 7, 99):
            data = r.get_data(i)
            assert tca3m.extract_a3m(data, s, h) == \
                jca3m.extract_a3m(data, s, h)
            assert tca3m.extract_matcher_results(data, s, skip_first=True) \
                == jca3m.extract_matcher_results(data, s, skip_first=True)


def test_profile2neff_parity(tmp_path, on_cpu):
    out = tmp_path / "neff.txt"
    run(["profile2neff", GOLDEN / "tprofile" / "profdb", out])
    assert out.read_bytes() == (GOLDEN / "dbops" / "neff.txt").read_bytes()


# -- enrich ---------------------------------------------------------------------


def enrich_inputs(tmp):
    """Three toy queries with many hits (a query sub-DB) and, as the target
    profile DB, the golden it_profile_0's profiles of the toy's first 30
    sequences and of those queries' hits; the profiles' member alignments
    are golden/toy/aln."""
    aln = entries_by_key(TOY / "aln")
    keys = set(range(30))
    for q in RICH[:3]:
        keys |= {int(line.split(b"\t")[0])
                 for line in aln[q].split(b"\n") if line}
    (tmp / "qkeys").write_text("".join(f"{k}\n" for k in RICH[:3]))
    (tmp / "pkeys").write_text("".join(f"{k}\n" for k in sorted(keys)))
    run(["createsubdb", tmp / "qkeys", TOY / "qdb", tmp / "q"])
    run(["createsubdb", tmp / "qkeys", f"{TOY / 'qdb'}_h", f"{tmp / 'q'}_h"])
    run(["createsubdb", tmp / "pkeys", TOY / "it_profile_0", tmp / "tprof"])
    return tmp / "q", tmp / "tprof"


@pytest.mark.slow
def test_enrich_matches_the_jax_package(tmp_path, on_cpu):
    """One iteration of `enrich` on 3 queries in both packages (about 9 s
    here and 17 s in the JAX package on one core): result DBs equal."""
    q, tprof = enrich_inputs(tmp_path)
    for name, fn in (("port", run), ("jax", run_jax)):
        fn(["enrich", q, TOY / "qdb", tprof, TOY / "aln", tmp_path / name,
            tmp_path / f"{name}_tmp", "--num-iterations", 1])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")


# -- the CLI, without JAX -----------------------------------------------------------

SUBPROCESS_RUN = """
import os, pathlib, shutil, sys
sys.path.insert(0, sys.argv[3])
from test_torch_msa import TOY, build_ca3m, enrich_inputs, sub_results
from mmseqs2_tpu_torch.cli import main
golden, tmp = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
q, tprof = enrich_inputs(tmp)
aln4 = sub_results(TOY / "aln", (99, 219, 52, 367), tmp / "aln4")
conv = golden / "convert"
for suf in (".tsv", "_h.tsv", "_seq.tsv", "_aln.tsv"):
    shutil.copy(conv / f"exin{suf}", tmp / f"exin{suf}")
T = str(tmp) + "/"
steps = [
    ["result2msa", TOY / "qdb", TOY / "qdb", aln4, T + "msa"],
    ["msa2profile", T + "msa", T + "prof"],
    ["profile2pssm", T + "prof", T + "pssm.tsv"],
    ["profile2consensus", T + "prof", T + "cons"],
    ["profile2repseq", T + "prof", T + "rep"],
    ["profile2neff", T + "prof", T + "neff.txt"],
    ["convertca3m", build_ca3m(tmp / "ca3m"), T + "convca3m"],
    ["filtera3m", golden / "msares" / "big.a3m", T + "filt.a3m"],
    ["msa2result", T + "msa", T + "m2r_seq", T + "m2r_res"],
    ["expandaln", TOY / "qdb", TOY / "qdb", aln4, TOY / "aln", T + "exp"],
    ["expand2profile", TOY / "qdb", TOY / "qdb", aln4, TOY / "aln",
     T + "exprof"],
    ["convertmsa", conv / "test.sto", T + "cmsa"],
    ["convertprofiledb", conv / "hhmdb", T + "cprof"],
    ["tsv2exprofiledb", T + "exin", T + "ex"],
    ["sequence2profile", q, T + "s2p"],
    ["enrich", q, TOY / "qdb", tprof, TOY / "aln", T + "enriched",
     T + "enrich_tmp", "--num-iterations", "1"]]
for argv in steps:
    assert main([str(a) for a in argv]) == 0, argv
    print("RAN", argv[0])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""

NEW_COMMANDS = ("result2msa", "msa2profile", "profile2pssm",
                "profile2consensus", "profile2repseq", "profile2neff",
                "convertca3m", "filtera3m", "msa2result", "expandaln",
                "expand2profile", "convertmsa", "convertprofiledb",
                "tsv2exprofiledb", "sequence2profile", "enrich")


def test_cli_runs_the_new_commands_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(GOLDEN),
                        str(tmp_path), str(REPO / "tests")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    ran = [line.split()[1] for line in r.stdout.splitlines()
           if line.startswith("RAN ")]
    assert sorted(ran) == sorted(NEW_COMMANDS)
    # every enriched query hits itself and, through its profiles' members,
    # other toy sequences
    out = entries_by_key(tmp_path / "enriched")
    assert sorted(out) == sorted(RICH[:3])
    for k, data in out.items():
        hits = [int(line.split(b"\t")[0]) for line in data.split(b"\n")
                if line]
        assert k in hits and len(hits) > 3, (k, hits)


def test_registry_has_the_jax_packages_commands():
    """110 commands, each with the JAX package's name, category and
    argument counts; the 16 of the MSA slice among them."""
    from mmseqs2_tpu.registry import COMMANDS as JAX_COMMANDS
    from mmseqs2_tpu_torch.registry import COMMANDS
    jax = {c.name: c for c in JAX_COMMANDS}
    assert len(COMMANDS) == 110
    for c in COMMANDS:
        j = jax[c.name]
        assert (c.category, c.min_db, c.max_db, c.usage) == \
            (j.category, j.min_db, j.max_db, j.usage), c.name
    assert set(NEW_COMMANDS) <= {c.name for c in COMMANDS}
