"""The single-profile SW entry points of the port (mmseqs2_tpu_torch.ops.sw:
sw_single, sw_score) with real lengths and two kernel forms: the form
choice at its edges, the strip plan, the lengths' contract on the plain
versions (checked, and changing no result), and the gapped exhaustive scan
through TargetStore. Every output is an integer, so agreement is exact.

The kernel tests need a CUDA card and skip without one; on the CPU the
wrappers run their plain versions:
    python -m pytest tests/test_torch_sw_single.py -m cuda"""

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch.ops import gapless as tg
from mmseqs2_tpu_torch.ops import sw as tsw

PAD = tg.PAD_LETTER
NEG = tg.NEG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, lq, lt, b, q_len, kind="normal"):
    """A (32, lq) profile whose rows past q_len and whose pad letter's row
    score NEG, and targets (lt, b) int8 whose columns past t_lens hold the
    pad letter; homologs of the query planted in half the lanes.
    "negative" scores every real cell below 0."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-4, 3, size=(32, 32))
    m = (m + m.T) // 2
    np.fill_diagonal(m, rng.integers(4, 12, size=32))
    q = rng.integers(0, 20, size=q_len)
    prof = np.full((32, lq), NEG, np.int32)
    prof[:, :q_len] = m[q, :].T
    if kind == "negative":
        prof[:, :q_len] = -1 - np.abs(prof[:, :q_len]) % 5
    prof[PAD, :q_len] = NEG
    t_lens = rng.integers(0, lt + 1, size=b).astype(np.int32)
    t_lens[0] = lt
    targets = np.full((lt, b), PAD, np.int8)
    for k in range(b):
        n = int(t_lens[k])
        t = rng.integers(0, 20, size=n)
        if k % 2 == 0 and n and q_len:
            w = min(q_len, n)
            frag = q[:w].copy()
            mut = rng.random(w) < 0.25
            frag[mut] = rng.integers(0, 20, size=int(mut.sum()))
            o = int(rng.integers(0, n - w + 1))
            t[o:o + w] = frag
        targets[:n, k] = t
    return torch.from_numpy(prof), torch.from_numpy(targets), \
        torch.from_numpy(t_lens)


# -- the form and the strip plan ----------------------------------------------

@pytest.mark.parametrize("args,form", [
    # the score bound, q_len * max(prof_max, 0) < 32768
    ((2978, 11, 11, 1), "int16"),           # 32,758: the largest at 11
    ((2979, 11, 11, 1), "int32"),           # 32,769
    ((32767, 1, 11, 1), "int16"),           # the largest score
    ((32768, 1, 11, 1), "int32"),           # one step past it
    ((1, 32767, 11, 1), "int16"),
    ((1, 32768, 11, 1), "int32"),
    ((4096, -3, 11, 1), "int16"),           # nothing positive: score 0
    ((0, 1 << 20, 11, 1), "int16"),         # no real row
    # the gap bound, go < 32768
    ((100, 11, 32767, 1), "int16"),
    ((100, 11, 32768, 1), "int32"),
    # the ramp: relative to the chunk's first row and formed in int32, so
    # the largest gaps with the largest score keep the int16 form
    ((2978, 11, 32767, 32767), "int16"),
    ((2979, 11, 32767, 32767), "int32"),    # past the score bound alone
    ((100, 11, 1, 2), "int32"),             # ge > go: no bound holds
])
def test_pick_form_at_its_edges(args, form):
    assert tsw.pick_form(*args) == form


@pytest.mark.parametrize("form", ["int16", "int32"])
def test_strip_plan_covers_the_query_in_the_fewest_chunks(form):
    """The SW kernel takes the strip plan of ops/gapless.py, for the form
    pick_form chooses: at the lengths around the int16 bound and the
    chunk edges it covers the query in the fewest chunks, with the
    smallest strip."""
    most = max(tg.ROWS[form])
    for q_len in [0, 1, 31, 32, 33, 500, 1023, 1024, 1025, 2048, 2049,
                  2978, 2979, 4096, 4097, 9000]:
        rows, chunks = tg.strip_plan(form, q_len)
        assert rows in tg.ROWS[form]
        assert chunks == max(-(-q_len // (32 * most)), 1)
        covered = tg.rows_computed(form, q_len)
        assert covered == 32 * rows * chunks >= q_len
        smaller = [r for r in tg.ROWS[form] if r < rows]
        assert all(32 * r * chunks < q_len for r in smaller)
    # a 2,978-residue BLOSUM62 query, the longest in int16: two chunks of
    # 48-row strips; one more residue takes int32: three chunks of 32
    assert tsw.pick_form(2978, 11, 11, 1) == "int16"
    assert tg.strip_plan("int16", 2978) == (48, 2)
    assert tg.strip_plan("int32", 2979) == (32, 3)


# -- the plain versions and the lengths' contract -----------------------------

GAPS = [(11, 1), (1, 1), (0, 0), (13, 2)]


@pytest.mark.parametrize("go,ge", GAPS)
@pytest.mark.parametrize("lq,lt,b,q_len", [(40, 48, 10, 29), (72, 64, 8, 72),
                                           (16, 24, 6, 3)])
def test_plain_with_lengths_equals_the_scan_of_the_real_cells(lq, lt, b,
                                                              q_len, go, ge):
    """The plain versions take the lengths, check them and scan every cell;
    the result is that of each lane scanned on its real cells alone (the
    profile cut to q_len rows, the target to t_lens[b] columns), which is
    what the kernel computes."""
    prof, targets, t_lens = make_case(lq * 7 + go, lq, lt, b, q_len)
    kw = dict(go=go, ge=ge)
    full = tsw.sw_single_plain(prof, targets, **kw)
    got = tsw.sw_single(prof, targets, q_len=q_len, t_lens=t_lens,
                        prof_max=int(prof.max()), **kw)
    for g, f in zip(got, full):
        assert torch.equal(g, f)
    assert torch.equal(tsw.sw_score(prof, targets, q_len=q_len,
                                    t_lens=t_lens, **kw), got[0])
    assert int(got[0].max()) > 0
    for k in range(b):
        n = int(t_lens[k])
        lane = tsw.sw_single_plain(prof[:, :q_len].contiguous(),
                                   targets[:n, k:k + 1].contiguous(), **kw)
        score = int(lane[0][0])
        assert score == int(got[0][k])
        if score > 0:
            assert (int(lane[1][0]), int(lane[2][0])) == (int(got[1][k]),
                                                          int(got[2][k]))
        else:
            assert (int(got[1][k]), int(got[2][k])) == (lq - 1, -1)


def test_all_negative_lanes_keep_the_sentinels():
    prof, targets, t_lens = make_case(3, 40, 32, 6, 30, kind="negative")
    got = tsw.sw_single(prof, targets, q_len=30, t_lens=t_lens)
    assert got[0].tolist() == [0] * 6
    assert got[1].tolist() == [39] * 6 and got[2].tolist() == [-1] * 6


def _breaches():
    """(name, profile, targets, kwargs) that break the contract."""
    prof, targets, t_lens = make_case(5, 24, 20, 4, 18)
    past_row = prof.clone()
    past_row[3, 20] = 0
    pad_row = prof.clone()
    pad_row[PAD, 2] = -5
    late = targets.clone()
    short = t_lens.clone()
    short[0] = 10
    return [
        ("q_len above lq", prof, targets, dict(q_len=25)),
        ("q_len below 0", prof, targets, dict(q_len=-1)),
        ("a real entry past q_len", past_row, targets, dict(q_len=18)),
        ("t_lens shape", prof, targets, dict(t_lens=t_lens[:3])),
        ("t_lens above lt", prof, targets,
         dict(t_lens=torch.full((4,), 21, dtype=torch.int32))),
        ("a real letter past t_lens", prof, late, dict(t_lens=short)),
        ("the pad letter scores on a real row", pad_row, targets,
         dict(q_len=18, t_lens=t_lens)),
        ("prof_max below the largest entry", prof, targets,
         dict(prof_max=int(prof.max()) - 1)),
    ]


@pytest.mark.parametrize("fn", ["sw_single", "sw_score", "sw_single_plain",
                                "sw_score_plain"])
@pytest.mark.parametrize("breach", range(8))
def test_each_contract_breach_raises(fn, breach):
    name, prof, targets, kw = _breaches()[breach]
    with pytest.raises(ValueError):
        getattr(tsw, fn)(prof, targets, **kw)


def test_cpu_runs_no_kernel_and_counts_no_launch():
    prof, targets, t_lens = make_case(9, 32, 24, 4, 20)
    before = [(w.launches, dict(w.form_launches))
              for w in (tsw.sw_single, tsw.sw_score)]
    tsw.sw_single(prof, targets, q_len=20, t_lens=t_lens)
    tsw.sw_score(prof, targets, q_len=20, t_lens=t_lens)
    assert before == [(w.launches, dict(w.form_launches))
                      for w in (tsw.sw_single, tsw.sw_score)]
    with pytest.raises(ValueError, match="no kernel"):
        tsw.sw_single(prof.to("meta"), targets.to("meta"))


# -- the gapped exhaustive scan through the store -----------------------------

@pytest.mark.parametrize("q_len", [50, 64])
def test_target_store_gapped_scan_passes_the_lengths(monkeypatch, q_len):
    """TargetStore.scan in the gapped mode: sw_single with track, sw_score
    without, each given q_len, t_lens and prof_max; both equal the scan
    without lengths (the store's results before it passed them), and a
    profile that scores the pad letter gets no target lengths."""
    import pathlib
    from mmseqs2_tpu_torch.commands import prefilter_cmd as pc
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops.encode import make_query_profile
    golden = pathlib.Path(__file__).resolve().parent / "golden" / "toy"
    submat = get_submat("blosum62.out", 2.0, 0.0)
    store = pc.TargetStore(EncodedDB(open_seq_db(str(golden / "qdb")),
                                     submat), "cpu")
    # a cut for time: the store's first three buckets
    store.blocks, store.block_lens, store.block_residues = (
        store.blocks[:3], store.block_lens[:3], store.block_residues[:3])
    rng = np.random.default_rng(q_len)
    profile = make_query_profile(
        rng.integers(0, 20, size=q_len), submat.sub_matrix.astype(np.int32),
        rng.integers(-3, 4, size=q_len).astype(np.int8))
    calls = []

    def record(fn):
        def wrapper(prof, block, **kw):
            calls.append((fn.__name__, kw))
            return fn(prof, block, **kw)
        return wrapper
    for name in ("sw_single", "sw_score"):
        monkeypatch.setattr(tsw, name, record(getattr(tsw, name)))
    pc.reset_stats()
    tracked = store.scan(profile, 0, pc.MODE_GAPPED, 11, 1)
    score_only = store.scan(profile, 0, pc.MODE_GAPPED, 11, 1, track=False)
    assert torch.equal(tracked, score_only)
    prof = torch.from_numpy(np.ascontiguousarray(profile))
    want = torch.cat([tsw.sw_single_plain(prof, block)[0]
                      for block in store.blocks])
    assert torch.equal(tracked, want) and int(want.max()) > 0
    n = len(store.blocks)
    assert [c[0] for c in calls] == ["sw_single"] * n + ["sw_score"] * n
    for (_, kw), lens in zip(calls, store.block_lens * 2):
        assert kw["q_len"] == q_len and kw["prof_max"] == profile.max()
        assert kw["t_lens"] is lens and (kw["go"], kw["ge"]) == (11, 1)
    rows = tg.rows_computed(tsw.pick_form(q_len, profile.max(), 11, 1),
                            q_len)
    assert pc.STATS["cells_computed"] == 2 * rows * sum(store.block_residues)
    calls.clear()
    profile[pc.PAD_LETTER, 0] = 1
    store.scan(profile, 0, pc.MODE_GAPPED, 11, 1)
    assert all(kw["t_lens"] is None for _, kw in calls)


# -- the kernel (needs the card) ----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lt,b,q_len,go,ge,kind", [
    (32, 40, 8, 32, 11, 1, "normal"),
    (72, 40, 17, 50, 13, 2, "normal"),
    (512, 300, 600, 400, 11, 1, "normal"),
    (512, 300, 600, 400, 1, 1, "normal"),          # cheap gaps: F runs long
    (512, 300, 200, 400, 0, 0, "normal"),
    (512, 300, 200, 400, 11, 1, "negative"),
    (2500, 200, 40, 2400, 11, 1, "normal"),        # strip-mined in int32
    (4096, 200, 40, 2900, 11, 1, "normal"),        # strip-mined in both
    (4096, 200, 40, 2900, 400, 300, "normal"),     # a ramp past 16 bits
])
@pytest.mark.parametrize("form", ["picked", "int32"])
@pytest.mark.parametrize("lengths", [True, False])
def test_kernel_matches_plain(cuda_device, lq, lt, b, q_len, go, ge, kind,
                              form, lengths):
    """sw_single and sw_score on the card against their plain versions, in
    the form pick_form chooses and in the int32 form (one entry raised so
    that it is chosen), with and without the real lengths."""
    prof, targets, t_lens = make_case(lq + q_len + go, lq, lt, b, q_len,
                                      kind)
    if form == "int32":
        prof[0, 0] = 40_000
    kw = dict(go=go, ge=ge)
    if lengths:
        kw.update(q_len=q_len, t_lens=t_lens, prof_max=int(prof.max()))
    want = tsw.sw_single_plain(prof, targets, **kw)
    expect = tsw.pick_form(q_len if lengths else lq, int(prof.max()), go, ge)
    if form == "int32":
        assert expect == "int32"
    dev = {k: v.to(cuda_device) if torch.is_tensor(v) else v
           for k, v in kw.items()}
    before = [dict(w.form_launches) for w in (tsw.sw_single, tsw.sw_score)]
    got = tsw.sw_single(prof.to(cuda_device), targets.to(cuda_device), **dev)
    got_s = tsw.sw_score(prof.to(cuda_device), targets.to(cuda_device),
                         **dev)
    torch.cuda.synchronize()
    for w, was in zip((tsw.sw_single, tsw.sw_score), before):
        assert w.form_launches[expect] == was[expect] + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_s, got[0])
    if kind != "negative":
        assert int(got[0].max()) > 0
    elif form == "picked":
        assert int(got[0].max()) == 0
