"""The port's profile stack (mmseqs2_tpu_torch.profile and its native helper)
and its `result2profile` and `filterresult` commands, with the CPU
requested: each module's functions against the JAX package's on the same
inputs (integers and bytes: exact), the commands against the reference
MMseqs2 goldens of tests/golden/toy (profdb, it_profile_0, it3_profile_1)
and against the JAX package's commands, and the aligner's profile queries
(Aligner.init_profile_query, score_identical) against the JAX Aligner.

Subsets are taken of result DBs, never of the query DB: a query subset
changes sameDB (identity injection, and result2profile skipping the
query's own key). JAX is imported inside the tests that compare with it."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import BUILD_DIR, cli
from mmseqs2_tpu_torch.db import dbtype as dbt
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
QDB = GOLDEN / "qdb"
KEYS = (0, 7, 42, 311)        # toy queries with several hits each


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


def result_subset(tmp_path, src, keys, name, keys_only=False):
    """The golden result DB `src` restricted to `keys`; with keys_only,
    each line cut to its target key (a cluster DB's format, which makes the
    commands align the hits again)."""
    out = str(tmp_path / name)
    with DBReader(str(GOLDEN / src)) as r, \
            DBWriter(out, dbt.DBTYPE_ALIGNMENT_RES) as w:
        for k in keys:
            data = r.get_data(r.get_id(k))
            if keys_only:
                data = b"".join(line.split(b"\t")[0] + b"\n"
                                for line in data.splitlines())
            w.write(k, data)
    return out


def hits_of(key, src="aln"):
    """result2profile's MSA input for a toy query from a golden result DB,
    through the port's and the JAX package's parsers."""
    from mmseqs2_tpu.commands import result2profile as jr
    from mmseqs2_tpu_torch.commands import result2profile as tr_
    with DBReader(str(GOLDEN / src)) as r:
        lines = [line.split(b"\t")
                 for line in r.get_data(r.get_id(key)).splitlines()]
    lines = [p for p in lines if int(p[0]) != key]
    return ([tr_.parse_aln_line(p) for p in lines],
            [jr.parse_aln_line(p) for p in lines])


def encoded(key_list):
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    sub = get_submat("blosum62.out", 2.0, 0.0)
    db = EncodedDB(open_seq_db(str(QDB)), sub)
    return sub, [db.seq_num(db.reader.get_id(k)) for k in key_list]


# -- the profile stack ----------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_parse_profile_and_alignment_profile_match_jax(key):
    from mmseqs2_tpu.profile import io as jio
    from mmseqs2_tpu_torch.profile import io as tio
    with DBReader(str(GOLDEN / "it_profile_0")) as r:
        data = r.get_data(r.get_id(key))
    tp, jp = tio.parse_profile(data), jio.parse_profile(data)
    for f in ("scores", "query_num", "consensus_num", "neff"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    assert tp.length == jp.length == len(data) // 25
    assert np.array_equal(tio.alignment_profile(tp),
                          jio.alignment_profile(jp))
    for a, b in zip(tio.kmer_rows(tp), jio.kmer_rows(jp)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("key", KEYS)
def test_msa_filter_pssm_and_buffer_match_jax(key):
    from mmseqs2_tpu.data.submat import get_submat as jget
    from mmseqs2_tpu.profile import filter as jfilter
    from mmseqs2_tpu.profile import msa as jmsa
    from mmseqs2_tpu.profile import pssm as jpssm
    from mmseqs2_tpu_torch.profile import filter as tfilter
    from mmseqs2_tpu_torch.profile import msa as tmsa
    from mmseqs2_tpu_torch.profile import pssm as tpssm
    t_hits, j_hits = hits_of(key)
    sub, seqs = encoded([key] + [h.db_key for h in t_hits])
    jsub = jget("blosum62.out", 2.0, 0.0)
    center, edges = seqs[0], seqs[1:]
    tm = tmsa.compute_msa_nodel(center, edges, t_hits)
    jm = jmsa.compute_msa_nodel(center, edges, j_hits)
    assert np.array_equal(tm, jm) and tm.shape[0] == len(t_hits) + 1
    fargs = (0, 0, -20.0, 90, 1000, 0)     # result2profile's defaults
    tk, tn = tfilter.filter_msa(tm, sub.sub_matrix, *fargs)
    jk, jn = jfilter.filter_msa(jm, jsub.sub_matrix, *fargs)
    assert np.array_equal(tk, jk) and tn == jn
    for wg in (False, True):
        to = tpssm.compute_pssm_from_msa(tm[tk], sub, wg)
        jo = jpssm.compute_pssm_from_msa(jm[jk], jsub, wg)
        for f in ("pssm", "profile", "neff", "consensus"):
            assert np.array_equal(to[f], jo[f]), (f, wg)
        assert tpssm.profile_to_buffer(
            to["pssm"], center, to["consensus"], to["neff"], sub.aa2num) \
            == jpssm.profile_to_buffer(jo["pssm"], center, jo["consensus"],
                                       jo["neff"], jsub.aa2num)


def test_native_helper_builds_into_the_port_and_matches_jax():
    """The port's copy of pssm_kernels.c builds into the git-ignored build
    directory (never into the package), and its nr_rcp and scalar_prod20
    are bit-equal to the JAX package's helper."""
    from mmseqs2_tpu import native as jnative
    from mmseqs2_tpu_torch import native as tnative
    tnative.get_lib()
    so = tnative.library_path()
    assert so.exists() and so.parent == BUILD_DIR
    assert not list(pathlib.Path(tnative.__file__).parent.glob("*.so"))
    rng = np.random.default_rng(3)
    x = rng.uniform(0.01, 400.0, size=1001).astype(np.float32)
    assert np.array_equal(tnative.nr_rcp(x).view(np.int32),
                          jnative.nr_rcp(x).view(np.int32))
    R = rng.random((20, 20), dtype=np.float32)
    f = rng.random((37, 20), dtype=np.float32)
    got = tnative.scalar_prod20(R, f)
    assert np.array_equal(got.view(np.int32),
                          jnative.scalar_prod20(R, f).view(np.int32))
    with pytest.raises(ValueError):
        tnative.scalar_prod20(R[:19], f)


# -- the commands ---------------------------------------------------------------

def test_result2profile_matches_profdb(tmp_path, on_cpu):
    """result2profile of the first 25 toy queries' alignments (golden aln)
    equals the reference's profdb entry by entry."""
    sub = result_subset(tmp_path, "aln", range(25), "alnsub")
    run(["result2profile", QDB, QDB, sub, tmp_path / "prof"])
    got = entries_by_key(tmp_path / "prof")
    want = entries_by_key(GOLDEN / "profdb")
    assert sorted(got) == list(range(25))
    bad = [k for k in got if got[k] != want[k]]
    assert not bad, f"profiles differ: {bad}"


def test_result2profile_matches_it_profile_0(tmp_path, on_cpu):
    """blastpgp's iteration-0 profile step (result2profile -e 0.001 of the
    --realign alignments) on a subset of it_aln_0."""
    keys = list(range(0, 500, 25))
    sub = result_subset(tmp_path, "it_aln_0", keys, "alnsub")
    run(["result2profile", QDB, QDB, sub, tmp_path / "prof", "-e", "0.001"])
    got = entries_by_key(tmp_path / "prof")
    want = entries_by_key(GOLDEN / "it_profile_0")
    assert sorted(got) == keys
    assert [k for k in keys if got[k] != want[k]] == []


def test_result2profile_of_profile_queries_matches_it3_profile_1(tmp_path,
                                                                on_cpu):
    """result2profile with a profile query DB (blastpgp iterations >= 2):
    it_profile_0's queries and a subset of the 3-iteration run's merged
    alignments give it3_profile_1's entries."""
    keys = list(range(3, 500, 31))
    sub = result_subset(tmp_path, "it3_aln_1", keys, "alnsub")
    run(["result2profile", GOLDEN / "it_profile_0", QDB, sub,
         tmp_path / "prof", "-e", "0.001"])
    got = entries_by_key(tmp_path / "prof")
    want = entries_by_key(GOLDEN / "it3_profile_1")
    assert [k for k in keys if got[k] != want[k]] == []


@pytest.mark.parametrize("keys_only", [False, True])
@pytest.mark.parametrize("command", ["filterresult", "result2profile"])
def test_command_matches_the_jax_package(tmp_path, on_cpu, command,
                                         keys_only):
    """filterresult and result2profile against the JAX package's commands
    on the same inputs; with key-only input both align every hit again
    (Aligner.align_query: sw_multi on the card)."""
    from mmseqs2_tpu_torch.align import aligner
    sub = result_subset(tmp_path, "aln", KEYS, "alnsub", keys_only)
    aligner.reset_stats()
    run([command, QDB, QDB, sub, tmp_path / "mine"])
    run_jax(command, [QDB, QDB, sub, tmp_path / "jax"])
    got = entries_by_key(tmp_path / "mine")
    assert got == entries_by_key(tmp_path / "jax")
    assert sorted(got) == sorted(KEYS) and any(got.values())
    assert (aligner.STATS["pairs"] > 0) == keys_only


# -- the aligner's profile queries ----------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_init_profile_query_and_score_identical_match_jax(key):
    from mmseqs2_tpu.align import aligner as jaligner
    from mmseqs2_tpu.data.submat import get_submat as jget
    from mmseqs2_tpu.ops.evalue import EvalueComputation as JEvalue
    from mmseqs2_tpu.profile.io import parse_profile as jparse
    from mmseqs2_tpu_torch.align import aligner as taligner
    from mmseqs2_tpu_torch.data.submat import get_submat as tget
    from mmseqs2_tpu_torch.ops.evalue import EvalueComputation as TEvalue
    from mmseqs2_tpu_torch.profile.io import parse_profile as tparse
    with DBReader(str(GOLDEN / "it_profile_0")) as r:
        data = r.get_data(r.get_id(key))
    tsub, jsub = tget("blosum62.out", 2.0, 0.0), jget("blosum62.out", 2.0,
                                                      0.0)
    ta = taligner.Aligner(tsub, 11, 1, TEvalue(10_000, tsub, 11, 1),
                          device="cpu")
    ja = jaligner.Aligner(jsub, 11, 1, JEvalue(10_000, jsub, 11, 1))
    tc, jc = ta.init_profile_query(tparse(data)), ja.init_profile_query(
        jparse(data))
    assert np.array_equal(tc.profile, jc.profile)
    assert np.array_equal(tc.q_num, jc.q_num) and tc.bias == jc.bias
    assert not tc.comp_bias_i8.any()
    L = len(tc.q_num)
    assert (tc.profile[20, :L] == 0).all()                  # X scores 0
    assert (tc.profile[:, L:] == -(1 << 20)).all()          # pad columns
    for mode in (0, 2):
        assert dataclasses.asdict(ta.score_identical(tc, tc.q_num, mode)) \
            == dataclasses.asdict(ja.score_identical(jc, jc.q_num, mode))
