"""The port's device k-mer prefilter (mmseqs2_tpu_torch.prefilter) against
the JAX package: every ported stage against its JAX counterpart on the same
arrays, then the port's DevicePrefilter against the port's host QueryMatcher
and against the JAX DevicePrefilter, hit for hit, on the cases of
tests/test_device_prefilter.py. Every value is an integer: tolerance 0.
The port runs on CPU tensors here (its rescore takes the plain version)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmseqs2_tpu.data.submat import get_submat as jax_get_submat
from mmseqs2_tpu.prefilter import device_stages as jds
from mmseqs2_tpu.prefilter import index_io as jax_index_io
from mmseqs2_tpu.prefilter.device import DevicePrefilter as JaxDevicePrefilter
from mmseqs2_tpu.prefilter.kmer_generator import (
    KmerGenerator as JaxKmerGenerator, SubKmerScores as JaxSubKmerScores)
from mmseqs2_tpu.prefilter.kmer_index import KmerIndexTable as JaxIndexTable

from mmseqs2_tpu_torch.data.submat import get_submat
from mmseqs2_tpu_torch.prefilter import device_stages as tds
from mmseqs2_tpu_torch.prefilter import index_io
from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
from mmseqs2_tpu_torch.prefilter.kmer_generator import (KmerGenerator,
                                                        SubKmerScores)
from mmseqs2_tpu_torch.prefilter.kmer_index import KmerIndexTable
from mmseqs2_tpu_torch.prefilter.query_matcher import QueryMatcher

I32_MAX = 2147483647
KMER_THR = 112


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    got = [g.numpy() for g in got] if isinstance(got, (tuple, list)) \
        else [got.numpy()]
    want = [np.asarray(w) for w in want] if isinstance(want, (tuple, list)) \
        else [np.asarray(want)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), i


# -- the stages, each fed the JAX outputs of the stage before -------------------

N_Q, N_T, TB, MAX_HITS, MIN_THR = 5, 37, 6, 4, 15


def make_flush(seed, h=4000, pad=96):
    """Shift-packed expansion keys with many repeated (qid, id) pairs and
    colliding u8 diagonals, I32_MAX padding at the end and inside."""
    rng = np.random.default_rng(seed)
    qid = np.sort(rng.integers(0, N_Q, size=h))
    ids = rng.integers(0, N_T, size=h)
    qtid = ((qid << TB) | ids).astype(np.int32)
    diag = (rng.integers(-2, 3, size=h) + 256 * rng.integers(0, 2, size=h)) \
        & 0xFFFF
    qtid = np.concatenate([qtid, np.full(pad, I32_MAX, np.int32)])
    diag = np.concatenate([diag, np.zeros(pad, np.int64)]).astype(np.int32)
    hole = rng.choice(h, size=20, replace=False)
    qtid[hole] = I32_MAX
    return qtid, diag


def jax_pipeline(seed):
    """Every intermediate of the JAX pipeline on one random flush."""
    rng = np.random.default_rng(seed + 100)
    qtid, diag = make_flush(seed)
    c_cap = len(qtid)
    s = {"qtid": qtid, "diag": diag, "c_cap": c_cap}
    s["sorted"] = jds._sort_dup_packed(jnp.asarray(qtid), jnp.asarray(diag),
                                       None, tb=TB)
    _, sdiag, _, hqid, ids, cand = s["sorted"]
    s["compact"] = jds._compact_candidates(cand, hqid, ids, sdiag,
                                           c_cap=c_cap)
    s["compact_small"] = jds._compact_candidates(cand, hqid, ids, sdiag,
                                                 c_cap=64)
    s["pre"] = jds.stage_candidates_pre(
        jnp.asarray(qtid), jnp.asarray(diag.astype(np.uint16)), c_cap=c_cap,
        tb=TB)
    cqid, cid, cdiag, cvalid, n_cand = s["compact"]
    # capped scores with many ties and some saturated
    cscore = rng.choice([0, 7, 20, 20, 31, 31, 31, 90, 255], size=c_cap)
    cscore = np.where(np.asarray(cvalid), cscore, 0).astype(np.int32)
    s["cscore"] = cscore
    s["is_best"] = jds.stage_keepmax(cqid, cid, jnp.asarray(cscore), cvalid,
                                     c_cap=c_cap)
    s["hist"] = jds.stage_hist(cqid, jnp.asarray(cscore), s["is_best"],
                               n_q=N_Q, c_cap=c_cap)
    s["thr"] = jds.threshold_from_hist(s["hist"], MAX_HITS, MIN_THR)
    s["identity"] = np.array([-1, 3, -1, 0, 7], np.int32)
    s["out_sz"] = N_Q * MAX_HITS
    s["select"] = jds.stage_select(
        cqid, cid, cdiag, jnp.asarray(cscore), cvalid, s["is_best"],
        s["thr"][0], jnp.asarray(s["identity"]), c_cap=c_cap,
        max_hits=MAX_HITS, out_sz=s["out_sz"])
    kqid, kid, kdiag, kscore, kvalid = s["select"]
    final = np.where(np.asarray(kscore) >= 255,
                     rng.integers(255, 900, size=s["out_sz"]),
                     np.asarray(kscore)).astype(np.int32)
    s["final"] = final
    s["finalize"] = jds.stage_finalize(kqid, kid, kdiag, jnp.asarray(final),
                                       kvalid)
    return s


@pytest.fixture(scope="module", params=[11, 12])
def flush(request):
    return jax_pipeline(request.param)


def test_sort_and_double_diagonal_detection(flush):
    got = tds.sort_dup_packed(tt(flush["qtid"]), tt(flush["diag"]), TB)
    same(got, flush["sorted"])
    assert int(got[5].sum()) > 50


def test_compaction(flush):
    _, sdiag, _, hqid, ids, cand = (tt(a) for a in flush["sorted"])
    for key, cap in (("compact", flush["c_cap"]), ("compact_small", 64)):
        got = tds.compact_candidates(cand, hqid, ids, sdiag, c_cap=cap)
        same(got, flush[key])


def test_stage_candidates_pre(flush):
    # the diagonal travels as the 16-bit pattern in an int16 tensor
    d16 = flush["diag"].astype(np.uint16).view(np.int16)
    got = tds.stage_candidates_pre(tt(flush["qtid"]), tt(d16),
                                   c_cap=flush["c_cap"], tb=TB)
    same(got, flush["pre"])


def test_keepmax_with_ties(flush):
    cqid, cid, _, cvalid, _ = (tt(a) for a in flush["compact"])
    got = tds.stage_keepmax(cqid, cid, tt(flush["cscore"]), cvalid,
                            c_cap=flush["c_cap"])
    same(got, flush["is_best"])
    assert 0 < int(got.sum()) < int(cvalid.sum())


def test_histogram_and_threshold(flush):
    cqid = tt(flush["compact"][0])
    hist = tds.stage_hist(cqid, tt(flush["cscore"]), tt(flush["is_best"]),
                          n_q=N_Q, c_cap=flush["c_cap"])
    same(hist, flush["hist"])
    same(tds.threshold_from_hist(hist, MAX_HITS, MIN_THR), flush["thr"])
    # a query with max_hits saturated hits is truncated
    h = np.zeros((2, 256), np.int32)
    h[0, 255], h[1, 40] = MAX_HITS, MAX_HITS + 1
    same(tds.threshold_from_hist(tt(h), MAX_HITS, MIN_THR),
         jds.threshold_from_hist(jnp.asarray(h), MAX_HITS, MIN_THR))


def test_select(flush):
    cqid, cid, cdiag, cvalid, _ = (tt(a) for a in flush["compact"])
    cscore = tt(flush["cscore"])
    got = tds.stage_select(
        cqid, cid, cdiag, cscore, cscore * 3 + 1, cvalid,
        tt(flush["is_best"]), tt(flush["thr"][0]), tt(flush["identity"]),
        c_cap=flush["c_cap"], max_hits=MAX_HITS, out_sz=flush["out_sz"])
    kqid, kid, kdiag, kscore, kexact, kvalid = got
    same((kqid, kid, kdiag, kscore, kvalid), flush["select"])
    # the carried exact score follows its hit
    assert torch.equal(kexact, torch.where(kvalid, kscore * 3 + 1, 0))
    # the identity hit is left out and takes one slot of max_hits
    per_q = np.bincount(kqid[kvalid].numpy(), minlength=N_Q)
    assert per_q.max() <= MAX_HITS and per_q[1] <= MAX_HITS - 1
    assert not ((kqid == 1) & (kid == 3)).any()


def test_finalize(flush):
    kqid, kid, kdiag, _, kvalid = (tt(a) for a in flush["select"])
    got = tds.stage_finalize(kqid, kid, kdiag, tt(flush["final"]), kvalid)
    same(got, flush["finalize"])


# -- DevicePrefilter ------------------------------------------------------------

rng = np.random.default_rng(7)


def make_seqs(n_seqs=60, lmin=20, lmax=90, alpha=20, related_frac=0.5):
    """Random targets where about half embed mutated copies of shared
    motifs, so k-mer double matches occur (tests/test_device_prefilter.py)."""
    motifs = [rng.integers(0, alpha, size=rng.integers(12, 30))
              for _ in range(6)]
    seqs = []
    for _ in range(n_seqs):
        L = int(rng.integers(lmin, lmax))
        s = rng.integers(0, alpha, size=L)
        if rng.random() < related_frac:
            m = motifs[int(rng.integers(len(motifs)))].copy()
            mut = rng.random(len(m)) < 0.1
            m[mut] = rng.integers(0, alpha, size=int(mut.sum()))
            p = int(rng.integers(0, max(L - len(m), 1)))
            s[p:p + len(m)] = m[:max(0, min(len(m), L - p))]
        seqs.append(s.astype(np.uint8))
    return seqs, motifs


def make_query(motifs, alpha=20, L=70):
    s = rng.integers(0, alpha, size=L)
    m = motifs[int(rng.integers(len(motifs)))]
    p = int(rng.integers(0, max(L - len(m), 1)))
    s[p:p + len(m)] = m[:max(0, min(len(m), L - p))]
    return s.astype(np.int64)


class Pair:
    """The port's DevicePrefilter and QueryMatcher beside the JAX
    DevicePrefilter, all three on the same numpy arrays: one target list,
    the same matrices and parameters, an index built by each package from
    the same sequences (and shown equal)."""

    def __init__(self, seqs, max_hits, kmer_thr=KMER_THR, exact=False):
        seed = get_submat("VTML80.out", 8.0, -0.2)
        ungapped = get_submat("blosum62.out", 2.0, -0.2)
        jseed = jax_get_submat("VTML80.out", 8.0, -0.2)
        jungapped = jax_get_submat("blosum62.out", 2.0, -0.2)
        assert np.array_equal(seed.sub_matrix, jseed.sub_matrix)
        assert np.array_equal(ungapped.sub_matrix, jungapped.sub_matrix)
        alpha = seed.alphabet_size - 1
        self_score = np.diag(seed.sub_matrix).astype(np.int64)
        table = KmerIndexTable(alpha, 6, spaced=True)
        table.build(seqs, alpha, kmer_thr, self_score)
        jtable = JaxIndexTable(alpha, 6, spaced=True)
        jtable.build(seqs, alpha, kmer_thr, self_score)
        for name in ("offsets", "entries_seq", "entries_pos"):
            assert np.array_equal(getattr(table, name), getattr(jtable, name))
        gen = jgen = None
        if not exact:
            gen = KmerGenerator(6, alpha,
                                SubKmerScores(seed.sub_matrix, alpha, 3),
                                SubKmerScores(seed.sub_matrix, alpha, 2))
            jgen = JaxKmerGenerator(
                6, alpha, JaxSubKmerScores(jseed.sub_matrix, alpha, 3),
                JaxSubKmerScores(jseed.sub_matrix, alpha, 2))
        self.host = QueryMatcher(table, seed, ungapped, kmer_thr, 6,
                                 max_hits=max_hits, generator=gen,
                                 take_only_best_kmer=exact)
        self.dev = DevicePrefilter(
            table, seed, ungapped, kmer_thr, 6, max_hits=max_hits,
            generator=gen, take_only_best_kmer=exact,
            host_fallback=self.host, device="cpu")
        self.jax = JaxDevicePrefilter(
            jtable, jseed, jungapped, kmer_thr, 6, max_hits=max_hits,
            generator=jgen, take_only_best_kmer=exact,
            host_fallback=self.host)
        self.table, self.seed, self.ungapped = table, seed, ungapped

    def check(self, queries, idents):
        got = self.dev.match_batch(queries, idents)
        theirs = self.jax.match_batch(queries, idents)
        for b, q in enumerate(queries):
            want = self.host.match(q, idents[b], diagonal_scoring=True)
            assert got[b] == want, (b, got[b][:5], want[:5])
            assert got[b] == theirs[b], (b, got[b][:5], theirs[b][:5])
        return got


@pytest.fixture(scope="module")
def world():
    seqs, motifs = make_seqs()
    return seqs, motifs, Pair(seqs, max_hits=20)


def test_device_matches_host_batch(world):
    seqs, motifs, pair = world
    got = pair.check([make_query(motifs) for _ in range(8)], [-1] * 8)
    assert sum(len(g) for g in got) > 8


def test_device_identity_injection(world):
    seqs, motifs, pair = world
    # query = an actual target sequence -> identity hit pinned first
    got = pair.check([seqs[3].astype(np.int64)], [3])
    assert got[0][0] == (3, 65535, 0)


def test_device_small_max_hits(world):
    seqs, motifs, _ = world
    pair = Pair(seqs, max_hits=3)
    got = pair.check([make_query(motifs) for _ in range(4)]
                     + [seqs[5].astype(np.int64)], [-1] * 4 + [5])
    assert max(len(g) for g in got) == 3


def test_device_exact_kmer_mode(world):
    seqs, motifs, _ = world
    pair = Pair(seqs, max_hits=20, kmer_thr=0, exact=True)
    # exact copies of targets so exact k-mer matching fires
    got = pair.check([seqs[i].astype(np.int64) for i in (0, 5, 9)], [-1] * 3)
    assert all(got)


def test_device_truncated_fallback():
    """Queries whose diagonal threshold saturates at 255 take the host
    rescoreHits route, and the port counts them."""
    base = rng.integers(0, 20, size=400).astype(np.uint8)
    pair = Pair([base.copy() for _ in range(30)], max_hits=5)
    before = pair.dev.host_oracle_queries
    got = pair.check([base.astype(np.int64)], [-1])
    assert pair.dev.host_oracle_queries == before + 1
    assert len(got[0]) == 5 and got[0][0][1] > 255


def test_device_saturated_hits_keep_exact_scores():
    """Hits past 255 that are kept without truncation carry the exact
    score (the JAX version rescored them in a second pass)."""
    base = rng.integers(0, 20, size=300).astype(np.uint8)
    seqs = [base.copy() for _ in range(3)] + make_seqs(20)[0]
    pair = Pair(seqs, max_hits=10)
    got = pair.check([base.astype(np.int64)], [-1])
    assert pair.dev.host_oracle_queries == 0
    assert sum(1 for h in got[0] if h[1] > 255) == 3


def test_batch_over_the_memory_limit_is_split(world, monkeypatch):
    seqs, motifs, pair = world
    queries = [make_query(motifs) for _ in range(6)]
    want = pair.dev.match_batch(queries, [-1] * 6)
    prepared = [pair.dev.prepare_query(q) for q in queries]
    vols = [len(p[5]) for p in prepared]
    calls = []
    real = DevicePrefilter._split_batch

    def spy(self, qs, ids, prep, *profiles):
        calls.append(len(qs))
        return real(self, qs, ids, prep, *profiles)

    monkeypatch.setattr(DevicePrefilter, "_split_batch", spy)
    # room for about two queries per device call
    monkeypatch.setattr(DevicePrefilter, "H_CAP_MAX", max(vols) * 2)
    got = pair.dev.match_batch(queries, [-1] * 6, prepared=prepared)
    assert calls and calls[0] == 6
    assert got == want
    # a single query over the limit goes to the host oracle
    monkeypatch.setattr(DevicePrefilter, "H_CAP_MAX", min(vols) - 1)
    before = pair.dev.host_oracle_queries
    assert pair.dev.match_batch(queries, [-1] * 6) == want
    assert pair.dev.host_oracle_queries == before + 6


def test_unported_query_kinds_raise(world):
    """Profile queries, which this test once showed were not ported: the
    port's device route (host expansion, the profile form of the rescore)
    against the host oracle and the JAX DevicePrefilter's profile route
    (_device_match), hit for hit, on random PSSMs that favour the targets'
    motifs."""
    from mmseqs2_tpu.prefilter.kmer_generator import (
        ProfileKmerGenerator as JaxProfileKmerGenerator)
    from mmseqs2_tpu_torch.commands.prefilter_kmer import profile_query
    from mmseqs2_tpu_torch.profile.io import ProfileEntry
    seqs, motifs, pair = world
    prng = np.random.default_rng(17)
    alpha = pair.seed.alphabet_size - 1
    profiles, queries = [], []
    for _ in range(4):
        q = make_query(motifs)
        scores = prng.integers(-40, 12, size=(len(q), 20))
        scores[np.arange(len(q)), q] = prng.integers(30, 80, size=len(q))
        p = ProfileEntry()
        p.scores, p.length = scores.astype(np.int8), len(q)
        p.query_num = q.astype(np.uint8)
        profiles.append(p)
        queries.append(q)
    gens, rps = zip(*(profile_query(p, 6, alpha, pair.table.offsets_pat)
                      for p in profiles))
    jgens = [JaxProfileKmerGenerator(6, alpha, g.scores, g.idx, g.offsets)
             for g in gens]
    got = pair.dev.match_batch(queries, [-1] * 4, list(rps), list(gens))
    theirs = pair.jax.match_batch(queries, [-1] * 4, list(rps), jgens)
    for b, q in enumerate(queries):
        want = pair.host.match(q, -1, diagonal_scoring=True,
                               rescore_profile=rps[b], generator=gens[b])
        assert got[b] == want and got[b] == theirs[b], b
    assert sum(len(g) for g in got) > 4


def test_index_saved_by_the_jax_package_loads_in_the_port(world, tmp_path):
    """The on-disk `.idx` DB is the shared format: an index written by the
    JAX package's save_index loads in the port's copy and gives the same
    hits."""
    seqs, motifs, pair = world
    jtable = pair.jax.index
    path = str(tmp_path / "t.idx")
    jax_index_io.save_index(path, jtable, dict(kmer_thr=KMER_THR, spaced=1,
                                               mask=0))
    table, meta = index_io.load_index(path)
    assert meta["kmer_thr"] == KMER_THR and table.k == 6
    for name in ("offsets", "entries_seq", "entries_pos"):
        assert np.array_equal(np.asarray(getattr(table, name)),
                              np.asarray(getattr(jtable, name)))
    dev = DevicePrefilter(
        table, pair.seed, pair.ungapped, KMER_THR, 6, max_hits=20,
        generator=pair.dev.generator, host_fallback=pair.host, device="cpu")
    queries = [make_query(motifs) for _ in range(3)]
    assert dev.match_batch(queries, [-1] * 3) == \
        pair.dev.match_batch(queries, [-1] * 3)


# -- the route past the packed key (the posting expansion on the device) -------

TOY = __import__("pathlib").Path(__file__).parent / "golden" / "toy"


@pytest.fixture(scope="module")
def toy():
    """Each package's DevicePrefilter over the toy DB's index at threshold
    0 (the profile queries' index; blosum62 seed), and the first 8 profiles
    of it_profile_0 with their generators and rescore profiles."""
    from mmseqs2_tpu.commands import prefilter_kmer as jpk
    from mmseqs2_tpu.commands.common import EncodedDB as JaxEncodedDB
    from mmseqs2_tpu.commands.common import open_seq_db as jax_open_seq_db
    from mmseqs2_tpu.prefilter.kmer_generator import (
        ProfileKmerGenerator as JaxProfileKmerGenerator)
    from mmseqs2_tpu_torch.commands import prefilter_kmer as tpk
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.profile.io import parse_profile
    seed = get_submat("blosum62.out", 8.0, -0.2)
    ungapped = get_submat("blosum62.out", 2.0, -0.2)
    jseed = jax_get_submat("blosum62.out", 8.0, -0.2)
    jungapped = jax_get_submat("blosum62.out", 2.0, -0.2)
    alpha = seed.alphabet_size - 1
    tdb = EncodedDB(open_seq_db(str(TOY / "qdb")), seed)
    table = tpk.build_index(tdb, seed, 6, 0, True, 0.9, False, True, "")
    jtable = jpk.build_index(JaxEncodedDB(jax_open_seq_db(str(TOY / "qdb")),
                                          jseed),
                             jseed, 6, 0, True, 0.9, False, True, "")
    for name in ("offsets", "entries_seq", "entries_pos"):
        assert np.array_equal(getattr(table, name), getattr(jtable, name))
    thr = tpk.get_kmer_threshold(5.7, 6)
    gen = KmerGenerator(6, alpha, SubKmerScores(seed.sub_matrix, alpha, 3),
                        SubKmerScores(seed.sub_matrix, alpha, 2))
    jgen = JaxKmerGenerator(6, alpha,
                            JaxSubKmerScores(jseed.sub_matrix, alpha, 3),
                            JaxSubKmerScores(jseed.sub_matrix, alpha, 2))
    host = QueryMatcher(table, seed, ungapped, thr, 6, 300, generator=gen)
    dev = DevicePrefilter(table, seed, ungapped, thr, 6, 300, generator=gen,
                          host_fallback=host, device="cpu")
    # the same index as a DevicePrefilter past 2^22 targets takes it: the
    # flag its target count would set
    route = DevicePrefilter(table, seed, ungapped, thr, 6, 300,
                            generator=gen, host_fallback=host, device="cpu")
    route.device_expansion = True
    jdev = JaxDevicePrefilter(jtable, jseed, jungapped, thr, 6, 300,
                              generator=jgen, host_fallback=host)
    with DBReader(str(TOY / "it_profile_0")) as r:
        profiles = [parse_profile(r.get_data(r.get_id(k)))
                    for k in range(0, 160, 20)]
    gens, rps = zip(*(tpk.profile_query(p, 6, alpha, table.offsets_pat)
                      for p in profiles))
    jgens = [JaxProfileKmerGenerator(6, alpha, g.scores, g.idx, g.offsets)
             for g in gens]
    return dict(
        dev=dev, route=route, jdev=jdev, host=host, tdb=tdb,
        pqueries=[p.query_num.astype(np.int64) for p in profiles],
        gens=list(gens), rps=list(rps), jgens=jgens)


def refuse_host_expansion(monkeypatch):
    """From here on the packed route and the host posting expansion raise:
    whatever matches does so by the route past the packed key."""
    def refuse(*args, **kw):
        raise AssertionError("took the packed route")
    monkeypatch.setattr(DevicePrefilter, "_match_pre_async", refuse)
    monkeypatch.setattr(DevicePrefilter, "_expand_host", refuse)


def test_route_past_the_packed_key_sequence_queries(toy, monkeypatch):
    """match_batch of a DevicePrefilter past 2^22 targets (prepare_query
    leaves the posting lists unexpanded; the CSR triples expand on the
    device through posting_expand; the int64-key sort) gives the packed
    route's hits and the JAX DevicePrefilter's on toy queries, self hits
    included; the index entries go to the device only with the route's
    first flush, and the packed route's store holds none."""
    dev, route = toy["dev"], toy["route"]
    queries = [toy["tdb"].seq_num(i) for i in range(0, 480, 40)]
    idents = [i if i % 80 == 0 else -1 for i in range(0, 480, 40)]
    packed = dev.match_batch(queries, idents)
    assert dev._d_entries is None and not dev.device_expansion
    refuse_host_expansion(monkeypatch)
    prepared = [route.prepare_query(q) for q in queries]
    assert all(p[5] is None and p[6] is None for p in prepared)
    got = route.match_batch(queries, idents)
    assert route._d_entries is not None
    assert route.match_batch(queries, idents, prepared=prepared) == got
    theirs = toy["jdev"].match_batch(queries, idents)
    assert got == packed == theirs
    assert sum(map(len, got)) > len(queries)


def test_route_past_the_packed_key_profile_queries(toy, monkeypatch):
    """The route with it_profile_0's profile queries (the profile form of
    the rescore) against the packed route and the JAX DevicePrefilter."""
    dev, route, q = toy["dev"], toy["route"], toy["pqueries"]
    idents = [-1] * len(q)
    packed = dev.match_batch(q, idents, toy["rps"], toy["gens"])
    refuse_host_expansion(monkeypatch)
    got = route.match_batch(q, idents, toy["rps"], toy["gens"])
    theirs = toy["jdev"].match_batch(q, idents, toy["rps"], toy["jgens"])
    assert got == packed == theirs
    assert sum(map(len, got)) > len(q)


def test_route_splits_a_batch_over_the_memory_limit(toy, monkeypatch):
    """Past H_CAP_MAX the route halves the batch (each half by the route)
    and hands a single query to the host oracle, as the packed route."""
    dev, route = toy["dev"], toy["route"]
    queries = [toy["tdb"].seq_num(i) for i in range(5, 85, 20)]
    want = dev.match_batch(queries, [-1] * 4)
    vols = [int(route.prepare_query(q)[1].sum()) for q in queries]
    refuse_host_expansion(monkeypatch)
    monkeypatch.setattr(DevicePrefilter, "H_CAP_MAX", max(vols) * 2)
    assert route.match_batch(queries, [-1] * 4) == want
    monkeypatch.setattr(DevicePrefilter, "H_CAP_MAX", min(vols) - 1)
    before = route.host_oracle_queries
    assert route.match_batch(queries, [-1] * 4) == want
    assert route.host_oracle_queries == before + 4


@pytest.mark.parametrize("kind", ["sequence", "profile"])
def test_prefilter_command_past_2_22_targets(kind, tmp_path, monkeypatch):
    """The `prefilter` command through _run_device with the target-id
    width of a DB past 2^22 targets (_tb 24, as 2^23 targets give): every
    flush goes by the route past the packed key (prepare_query leaves the
    lists unexpanded, match_batch_async sends the flush to
    _match_expand_async, the flush budget counts the triples' expansions),
    and the entries equal the golden's: the first 8 toy queries with
    their self hits against pref, it_profile_0's profiles at -s 5.7
    against it_pref_tmp_1."""
    from mmseqs2_tpu_torch import cli
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.db.writer import DBWriter
    from mmseqs2_tpu_torch.device import ENV
    monkeypatch.setenv(ENV, "cpu")
    monkeypatch.setattr(DevicePrefilter, "_tb", lambda self: 24)
    refuse_host_expansion(monkeypatch)
    if kind == "sequence":
        src, keys, golden = TOY / "qdb", list(range(8)), TOY / "pref"
        flags, suffixes = ["--add-self-matches"], ("", "_h")
    else:
        src, keys = TOY / "it_profile_0", list(range(0, 200, 20))
        golden, flags, suffixes = TOY / "it_pref_tmp_1", ["-s", "5.7"], ("",)
    q = str(tmp_path / "q")
    for suffix in suffixes:
        with DBReader(str(src) + suffix) as r, \
                DBWriter(q + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    out = tmp_path / "pref"
    assert cli.main(["prefilter", q, str(TOY / "qdb"), str(out),
                     *flags]) == 0
    with DBReader(str(out)) as r, DBReader(str(golden)) as g:
        assert sorted(r.get_db_key(i) for i in range(r.size)) == keys
        assert [k for k in keys
                if r.get_data(r.get_id(k)) != g.get_data(g.get_id(k))] == []


def test_route_is_taken_past_2_22_targets():
    """A target set past 2^22 sequences takes the route: its full flush's
    packed key would not fit i32. The store is a CatSeqs-like layout of
    empty sequences; nothing but the flag is asked of it."""

    class Seqs:
        def __init__(self, n):
            self.lens = np.zeros(n, np.int32)
            self.cat = np.zeros(0, np.uint8)

        def __len__(self):
            return len(self.lens)

    class Table:
        def __init__(self, n):
            self.masked_seqs = Seqs(n)

    seed = get_submat("blosum62.out", 8.0, -0.2)
    for n, want in ((1 << 22, False), ((1 << 22) + 1, True)):
        dev = DevicePrefilter(Table(n), seed, seed, 100, 6, 300,
                              device="cpu")
        assert dev.device_expansion is want and dev._d_entries is None
