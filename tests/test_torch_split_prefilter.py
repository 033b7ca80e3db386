"""Target-split mode of the port's prefilter: DevicePrefilter's
candidates_batch (one split's per-(query, id) best candidates, expanded on
the device) against the JAX package's, prefilter/split_merge.finalize_query
against the JAX copy on random fragments (the rescale path included), and
`prefilter` with target splits, each run equal to its golden and leaving no
<out>.split_tmp: --split 3, the automatic split of --split-memory-limit
100K, a run of several query chunks, and profile queries (it_profile_0)
with --split 2 against it_pref_tmp_1. Every value is an integer:
tolerance 0. The port runs on CPU tensors here (its kernels take their
plain versions)."""

import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import prefilter_kmer
from mmseqs2_tpu_torch.data.submat import get_submat
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.prefilter import split_merge as tsm
from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
from mmseqs2_tpu_torch.prefilter.kmer_generator import (KmerGenerator,
                                                        SubKmerScores)
from mmseqs2_tpu_torch.prefilter.kmer_index import KmerIndexTable

GOLDEN = pathlib.Path(__file__).parent / "golden" / "toy"
QDB = GOLDEN / "qdb"
KMER_THR = 112


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


# -- candidates_batch ---------------------------------------------------------

def make_world(rng, n_seqs=60, alpha=20):
    """Random targets, half of them holding mutated copies of shared
    motifs, and three copies of one 300-letter sequence (whose queries
    saturate past 255)."""
    motifs = [rng.integers(0, alpha, size=rng.integers(12, 30))
              for _ in range(6)]
    seqs = []
    for _ in range(n_seqs):
        s = rng.integers(0, alpha, size=int(rng.integers(20, 90)))
        if rng.random() < 0.5:
            m = motifs[int(rng.integers(len(motifs)))].copy()
            m[rng.random(len(m)) < 0.1] = rng.integers(0, alpha)
            p = int(rng.integers(0, max(len(s) - len(m), 1)))
            s[p:p + len(m)] = m[:max(0, min(len(m), len(s) - p))]
        seqs.append(s.astype(np.uint8))
    base = rng.integers(0, alpha, size=300).astype(np.uint8)
    seqs += [base.copy() for _ in range(3)]
    queries = []
    for _ in range(7):
        q = rng.integers(0, alpha, size=70)
        m = motifs[int(rng.integers(len(motifs)))]
        p = int(rng.integers(0, 70 - len(m)))
        q[p:p + len(m)] = m
        queries.append(q.astype(np.int64))
    queries.append(base.astype(np.int64))
    return seqs, queries


def candidates_pair():
    """The port's and the JAX DevicePrefilter over one random world, and
    each one's prepared queries."""
    from mmseqs2_tpu.data.submat import get_submat as jax_get_submat
    from mmseqs2_tpu.prefilter.device import (
        DevicePrefilter as JaxDevicePrefilter)
    from mmseqs2_tpu.prefilter.kmer_generator import (
        KmerGenerator as JaxKmerGenerator,
        SubKmerScores as JaxSubKmerScores)
    from mmseqs2_tpu.prefilter.kmer_index import (
        KmerIndexTable as JaxIndexTable)
    rng = np.random.default_rng(23)
    seqs, queries = make_world(rng)
    seed = get_submat("VTML80.out", 8.0, -0.2)
    ungapped = get_submat("blosum62.out", 2.0, -0.2)
    jseed = jax_get_submat("VTML80.out", 8.0, -0.2)
    alpha = seed.alphabet_size - 1
    self_score = np.diag(seed.sub_matrix).astype(np.int64)
    table = KmerIndexTable(alpha, 6, spaced=True)
    table.build(seqs, alpha, KMER_THR, self_score)
    jtable = JaxIndexTable(alpha, 6, spaced=True)
    jtable.build(seqs, alpha, KMER_THR, self_score)
    gen = KmerGenerator(6, alpha, SubKmerScores(seed.sub_matrix, alpha, 3),
                        SubKmerScores(seed.sub_matrix, alpha, 2))
    jgen = JaxKmerGenerator(6, alpha,
                            JaxSubKmerScores(jseed.sub_matrix, alpha, 3),
                            JaxSubKmerScores(jseed.sub_matrix, alpha, 2))
    dev = DevicePrefilter(table, seed, ungapped, KMER_THR, 6, 20,
                          generator=gen, device="cpu")
    jdev = JaxDevicePrefilter(jtable, jseed,
                              jax_get_submat("blosum62.out", 2.0, -0.2),
                              KMER_THR, 6, 20, generator=jgen)
    prepared = [dev.prepare_query(q)[:5] for q in queries]
    jprep = [(p[0].astype(np.int32), p[1], p[2],
              ungapped.sub_matrix[q].astype(np.int32) + p[4][:, None])
             for q, p in zip(queries, prepared)]
    return dev, jdev, queries, prepared, jprep


def test_candidates_batch_matches_jax():
    """Per query the same local ids, diagonals, capped scores and exact
    scores of the saturated candidates as the JAX candidates_batch (whose
    exact scores come from a second program, the port's from the same
    rescore launch)."""
    dev, jdev, queries, prepared, jprep = candidates_pair()
    got = dev.candidates_batch(prepared, queries)
    want = jdev.candidates_batch(jprep, [len(q) for q in queries])
    assert len(got) == len(want) == len(queries)
    for b, (g, w) in enumerate(zip(got, want)):
        for x, y in zip(g[:3], w[:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y), b
        assert g[3] == w[3], b
    assert sum(len(g[0]) for g in got) > 20
    assert len(got[-1][3]) == 3 and min(got[-1][3].values()) > 255


def test_candidates_batch_halves_past_the_limit(monkeypatch):
    """Past H_CAP_MAX expansions a batch goes to the device in halves (a
    single query whole, as split mode has no host oracle); the fragments
    are the JAX candidates_batch's of the whole batch."""
    dev, jdev, queries, prepared, jprep = candidates_pair()
    vols = [int(p[1].sum()) for p in prepared]
    calls = []
    real = DevicePrefilter.candidates_batch

    def spy(self, prep, qs):
        calls.append(len(qs))
        return real(self, prep, qs)

    monkeypatch.setattr(DevicePrefilter, "candidates_batch", spy)
    monkeypatch.setattr(DevicePrefilter, "H_CAP_MAX", min(vols) - 1)
    got = dev.candidates_batch(prepared, queries)
    want = jdev.candidates_batch(jprep, [len(q) for q in queries])
    assert calls[0] == len(queries) and calls.count(1) == len(queries)
    for b, (g, w) in enumerate(zip(got, want)):
        for x, y in zip(g[:3], w[:3]):
            assert np.array_equal(x, y), b
        assert g[3] == w[3], b


# -- finalize_query -----------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "identity", "rescale"])
def test_finalize_query_matches_jax(case):
    """finalize_query on random merged fragments (ids ascending, counts in
    [0, 255]) against the JAX copy: the adaptive threshold, the identity
    hit, exact scores of saturated hits, and the rescoreHits rescale path
    (more saturated candidates than max_hits: diagonal_thr >= 255)."""
    from mmseqs2_tpu.prefilter import split_merge as jsm
    rng = np.random.default_rng({"plain": 1, "identity": 2,
                                 "rescale": 3}[case])
    n = 400
    ids = np.sort(rng.choice(5000, size=n, replace=False)).astype(np.int64)
    diags = rng.integers(0, 1 << 16, size=n).astype(np.uint16)
    counts = rng.choice([0, 5, 15, 16, 40, 90, 200, 255], size=n)
    max_hits = 30
    if case == "rescale":
        counts[rng.random(n) < 0.3] = 255
    ident = int(ids[7]) if case == "identity" else -1

    def exact_fn(i, d):
        return 255 + (np.asarray(i, np.int64) * 7 + np.asarray(d)) % 900

    args = (ids, diags, counts, max_hits, 15, ident, exact_fn, 800)
    got = tsm.finalize_query(*args)
    assert got == jsm.finalize_query(*args)
    assert len(got) == max_hits
    prof = rng.integers(-4, 8, size=(60, 21))
    q = rng.integers(0, 20, size=60)
    assert tsm.self_ungapped_score(prof, q) == jsm.self_ungapped_score(prof, q)


# -- the command --------------------------------------------------------------

def run(args):
    assert cli.main([str(a) for a in args]) == 0


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def subset(tmp_path, src, keys, name, headers=True):
    out = str(tmp_path / name)
    for suffix in ("", "_h") if headers else ("",):
        with DBReader(str(src) + suffix) as r, \
                DBWriter(out + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    return out


KEYS8 = list(range(8))


def split_run(tmp_path, query, golden, keys, flags):
    """prefilter of `query` against the toy DB with `flags`: its entries
    equal golden's for `keys`, one index build a split, no spill left."""
    prefilter_kmer.reset_stats()
    out = tmp_path / "pref"
    run(["prefilter", query, QDB, out, *flags])
    got, want = entries_by_key(out), entries_by_key(golden)
    assert sorted(got) == keys
    assert [k for k in keys if got[k] != want[k]] == []
    assert not (tmp_path / "pref.split_tmp").exists()
    st = prefilter_kmer.STATS
    assert len(st["split_index_s"]) == len(st["split_candidates_s"]) > 1
    assert st["split_spill_bytes"] > 0 and st["queries"] == len(keys)
    return st


def test_split_prefilter_matches_golden(tmp_path, on_cpu):
    """--split 3 --split-mode 0 of the first 8 toy queries (with their self
    hits) gives the golden pref's entries, as the JAX package's run does
    (tests/test_split_prefilter.py)."""
    q = subset(tmp_path, QDB, KEYS8, "qsub")
    st = split_run(tmp_path, q, GOLDEN / "pref", KEYS8,
                   ["--add-self-matches", "--split", "3", "--split-mode",
                    "0"])
    assert len(st["split_index_s"]) == 3


def test_automatic_split_matches_golden(tmp_path, on_cpu):
    """--split-memory-limit 100K: _auto_split_count splits the toy targets
    (34 splits), and the entries are the golden's."""
    q = subset(tmp_path, QDB, KEYS8, "qsub")
    st = split_run(tmp_path, q, GOLDEN / "pref", KEYS8,
                   ["--add-self-matches", "--split-memory-limit", "100K"])
    assert len(st["split_index_s"]) > 3


def test_split_prefilter_in_query_chunks(tmp_path, on_cpu, monkeypatch):
    """Three query chunks (of 3, 3 and 2 queries), each spilled and merged
    on its own, give the golden's entries."""
    monkeypatch.setattr(prefilter_kmer, "SPLIT_QCHUNK", 3)
    q = subset(tmp_path, QDB, KEYS8, "qsub")
    st = split_run(tmp_path, q, GOLDEN / "pref", KEYS8,
                   ["--add-self-matches", "--split", "2"])
    assert st["flushes"] == 2 * 3


def test_profile_query_split_matches_golden(tmp_path, on_cpu):
    """Profile queries (it_profile_0, their rescore rows pssm/4 with X at
    0) with --split 2 at -s 5.7 give it_pref_tmp_1's entries, as the JAX
    package's split run does."""
    keys = list(range(0, 200, 20))
    q = subset(tmp_path, GOLDEN / "it_profile_0", keys, "prof",
               headers=False)
    split_run(tmp_path, q, GOLDEN / "it_pref_tmp_1", keys,
              ["-s", "5.7", "--split", "2"])
