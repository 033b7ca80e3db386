"""The port's profile searches with the CPU requested: profile queries in
`prefilter` (the device route's flushes with the profile form of the
rescore, against the host matcher and against the reference's
it_pref_tmp_1) and in `align` (it_aln_tmp_1), `search --exhaustive-search`
(sliced/refout, refout2), `search` against profile targets
(tprofile/refout) and `search --num-iterations` (against the JAX package's
workflow on a few queries; the full toy workflows against italn and
italn3 are `slow`). Also: those commands load neither JAX nor the JAX
package, and the commands of later slices still say they are not ported.

Subsets are taken of the profile query DB and of result DBs: the profile
queries are never the target DB, so sameDB does not change."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import prefilter_kmer
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
QDB = GOLDEN / "qdb"
PROFILE = GOLDEN / "it_profile_0"
PROFILE_KEYS = list(range(0, 500, 20))


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


def subset(tmp_path, src, keys, name, headers=False):
    """The DB `src` restricted to `keys` (and its headers DB, if asked)."""
    out = str(tmp_path / name)
    for suffix in ("", "_h") if headers else ("",):
        with DBReader(str(src) + suffix) as r, \
                DBWriter(out + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    return out


def test_profile_query_prefilter_matches_golden(tmp_path, on_cpu):
    """prefilter of profile queries (it_profile_0) against the toy DB at
    -s 5.7: the device route's flushes (the profile form of the rescore,
    its plain version on the CPU) give it_pref_tmp_1's entries, and each
    flush uploads its queries' (B, Lq, 32) int8 profiles."""
    prof = subset(tmp_path, PROFILE, PROFILE_KEYS, "prof")
    prefilter_kmer.reset_stats()
    run(["prefilter", prof, QDB, tmp_path / "pref", "-s", "5.7"])
    got = entries_by_key(tmp_path / "pref")
    want = entries_by_key(GOLDEN / "it_pref_tmp_1")
    assert sorted(got) == PROFILE_KEYS
    assert [k for k in PROFILE_KEYS if got[k] != want[k]] == []
    st = prefilter_kmer.STATS
    assert st["flushes"] >= 1 and st["queries"] == len(PROFILE_KEYS)
    assert st["profile_bytes"] >= 32 * sum(
        len(v) // 25 for v in entries_by_key(prof).values())
    assert st["prep_s"] > 0


def test_device_route_equals_host_matcher_for_profile_queries():
    """DevicePrefilter's profile-query flushes on the CPU against the host
    matcher (the oracle, with each query's generator and rescore profile),
    hit for hit; a query over the device call's limit goes to the oracle
    with its own generator and profile."""
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
    from mmseqs2_tpu_torch.prefilter.query_matcher import QueryMatcher
    from mmseqs2_tpu_torch.profile.io import parse_profile
    seed = get_submat("blosum62.out", 8.0, -0.2)
    ungapped = get_submat("blosum62.out", 2.0, -0.2)
    tdb = EncodedDB(open_seq_db(str(QDB)), seed)
    k, thr = 6, prefilter_kmer.get_kmer_threshold(5.7, 6, is_profile=True)
    table = prefilter_kmer.build_index(tdb, seed, k, 0, True, 0.9, False,
                                       True, "")
    oracle = QueryMatcher(table, seed, ungapped, thr, k, 300)
    dev = DevicePrefilter(table, seed, ungapped, thr, k, 300,
                          host_fallback=oracle, device="cpu")
    with DBReader(str(PROFILE)) as r:
        profiles = [parse_profile(r.get_data(r.get_id(key)))
                    for key in PROFILE_KEYS[:8]]
    gens, rps = zip(*(prefilter_kmer.profile_query(
        p, k, seed.alphabet_size - 1, table.offsets_pat) for p in profiles))
    queries = [p.query_num.astype(np.int64) for p in profiles]
    want = [oracle.match(q, -1, rescore_profile=rp, generator=g)
            for q, g, rp in zip(queries, gens, rps)]
    got = dev.match_batch(queries, [-1] * 8, list(rps), list(gens))
    assert got == want and sum(map(len, want)) > 8
    assert dev.host_oracle_queries == 0 and dev.profile_bytes > 0
    dev.H_CAP_MAX = 1                     # every query over the limit
    assert dev.match_batch(queries, [-1] * 8, list(rps), list(gens)) == want
    assert dev.host_oracle_queries == 8 and oracle.generator is None


def test_profile_query_align_matches_golden(tmp_path, on_cpu):
    """align of profile queries (iteration 1 of blastpgp): it_profile_0's
    queries and a subset of it_pref_1 give it_aln_tmp_1's entries."""
    prof = subset(tmp_path, PROFILE, PROFILE_KEYS, "prof")
    pref = subset(tmp_path, GOLDEN / "it_pref_1", PROFILE_KEYS, "pref")
    run(["align", prof, QDB, pref, tmp_path / "aln", "-a", "1", "-e",
         "0.001"])
    got = entries_by_key(tmp_path / "aln")
    want = entries_by_key(GOLDEN / "it_aln_tmp_1")
    assert [k for k in PROFILE_KEYS if got[k] != want[k]] == []
    assert sum(map(len, got.values())) > 0


def test_profile_queries_cannot_be_realigned(tmp_path, on_cpu):
    prof = subset(tmp_path, PROFILE, PROFILE_KEYS[:2], "prof")
    pref = subset(tmp_path, GOLDEN / "it_pref_1", PROFILE_KEYS[:2], "pref")
    with pytest.raises(SystemExit):
        cli.main([str(a) for a in ("align", prof, QDB, pref,
                                   tmp_path / "aln", "--realign", "1")])


@pytest.mark.parametrize("filt,golden", [(0, "refout"), (1, "refout2")])
def test_exhaustive_search_matches_goldens(tmp_path, on_cpu, filt, golden):
    """search --exhaustive-search (the sliced search: profile queries in
    prefilter and align, filterresult with the filter on) equals the
    reference's sliced/refout and refout2."""
    out = tmp_path / "out"
    run(["search", REPO / "tests" / "golden" / "fm" / "qsub", PROFILE, out,
         tmp_path / "tmp", "--exhaustive-search", "1",
         "--exhaustive-search-filter", filt, "-a", "--threads", "1"])
    want = entries_by_key(REPO / "tests" / "golden" / "sliced" / golden)
    assert entries_by_key(out) == want


def test_search_against_profile_targets_matches_golden(tmp_path, on_cpu):
    """Sequence queries against a profile DB (searchtargetprofile.sh: the
    profile-target index on the host matcher, align in the swapped
    direction, swapresults) equal tprofile/refout."""
    t = REPO / "tests" / "golden" / "tprofile"
    out = tmp_path / "out"
    run(["search", t / "qs", t / "profdb", out, tmp_path / "tmp"])
    want = entries_by_key(t / "refout")
    assert entries_by_key(out) == want and any(want.values())


def test_iterative_search_matches_the_jax_workflow(tmp_path, on_cpu):
    """search --num-iterations 2 on four queries against 127 toy targets
    runs every step (prefilter, align --realign, result2profile, the
    profile-query prefilter, subtractdbs, the profile-query align,
    mergedbs) and equals the JAX package's workflow byte for byte."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    from mmseqs2_tpu_torch.workflow.engine import STEP_SECONDS
    q = subset(tmp_path, QDB, [0, 7, 42, 311], "q", headers=True)
    t = subset(tmp_path, QDB, list(range(0, 500, 4)) + [7, 311], "t",
               headers=True)
    STEP_SECONDS.clear()
    run(["search", q, t, tmp_path / "aln", tmp_path / "tmp",
         "--num-iterations", "2"])
    assert sorted(STEP_SECONDS) == ["align", "mergedbs", "prefilter",
                                    "result2profile", "subtractdbs"]
    cmd = get_command("search")
    par = Params().parse([q, t, str(tmp_path / "jaln"),
                          str(tmp_path / "jtmp"), "--num-iterations", "2"],
                         cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    for suffix in ("", ".index", ".dbtype"):
        assert (tmp_path / f"aln{suffix}").read_bytes() == \
            (tmp_path / f"jaln{suffix}").read_bytes(), suffix
    assert sum(map(len, entries_by_key(tmp_path / "aln").values())) > 0


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
golden, tmp = sys.argv[1], sys.argv[2]
for name, keys in (("q", [0, 7]), ("t", list(range(0, 500, 10)) + [7])):
    for suffix in ("", "_h"):
        with DBReader(golden + "/qdb" + suffix) as r, \\
                DBWriter(tmp + "/" + name + suffix, r.base_type,
                         r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
assert main(["search", tmp + "/q", tmp + "/t", tmp + "/aln", tmp + "/tmp",
             "--num-iterations", "2", "--remove-tmp-files", "0"]) == 0
assert main(["result2profile", tmp + "/q", tmp + "/t", tmp + "/aln",
             tmp + "/prof"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_iterative_search_and_result2profile_load_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(GOLDEN),
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    with DBReader(str(tmp_path / "prof")) as p:
        assert p.base_type == dbt.DBTYPE_HMM_PROFILE and p.size == 2


@pytest.mark.parametrize("args", [
    ["apply", PROFILE, "{out}", "--", "cat"],
    ["convertkb", "{tmp}/uniprot.dat", "{out}"],
], ids=["apply", "convertkb"])
def test_later_commands_exit_1_not_yet_ported(tmp_path, args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    argv = [str(a).format(out=tmp_path / "out", tmp=tmp_path / "tmp")
            for a in args]
    r = subprocess.run([sys.executable, "-m", "mmseqs2_tpu_torch", *argv],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "not yet ported (see ROADMAP.md)" in r.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.slow
@pytest.mark.parametrize("iterations,golden", [(2, "italn"), (3, "italn3")])
def test_full_toy_iterative_search_matches_golden(tmp_path, on_cpu,
                                                  iterations, golden):
    """search qdb qdb --num-iterations 2 and 3 on all 500 toy queries:
    data and index byte for byte equal to italn and italn3 (about 4 and 7
    minutes on the CPU)."""
    out = tmp_path / "aln"
    run(["search", QDB, QDB, out, tmp_path / "tmp", "--num-iterations",
         iterations])
    for suffix in ("", ".index"):
        assert (tmp_path / f"aln{suffix}").read_bytes() == \
            (GOLDEN / f"{golden}{suffix}").read_bytes(), suffix
