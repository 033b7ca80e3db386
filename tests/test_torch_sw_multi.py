"""The multi-profile SW entry points of the port (mmseqs2_tpu_torch.ops.sw:
sw_multi, sw_offset) with the row window: the plain versions with the
lengths against the scan of every cell and against the cells the kernel
computes (its strip plan, each window from the strip holding qoff), the
contract's breaches, the form for a window, and the aligner that passes
what it knows, against the JAX Aligner. Every output is an integer, so
agreement is exact.

The kernel cases need a CUDA card and skip without one (on the CPU the
wrappers run their plain versions):
    python -m pytest tests/test_torch_sw_multi.py tests/test_torch_sw.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch.ops import gapless as tg
from mmseqs2_tpu_torch.ops import sw as tsw

PAD = tsw.PAD_LETTER
NEG = tsw.NEG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, nq, lq, lt, b, min_len=1, reverse=False):
    """nq profiles of mixed real lengths in [min_len, lq] (rows past them
    and the pad letter's row score NEG; reverse: each profile reversed, pad
    rows first, as the aligner's reverse pass reads it), targets (lt, b) of
    real lengths t_lens (the pad letter past them), qsel, and an offset per
    lane in [0, lq]; homologs planted in half the lanes. Returns tensors
    (prof_flat, targets_t, qsel, qoff, q_lens, t_lens)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-4, 3, size=(32, 32))
    m = (m + m.T) // 2
    np.fill_diagonal(m, rng.integers(4, 12, size=32))
    q_lens = rng.integers(min_len, lq + 1, size=nq).astype(np.int32)
    q_lens[0] = lq
    profs, seqs = [], []
    for n in q_lens:
        q = rng.integers(0, 20, size=n)
        prof = np.full((32, lq), NEG, np.int32)
        prof[:, :n] = m[q, :].T
        prof[PAD] = NEG
        profs.append(prof[:, ::-1] if reverse else prof)
        seqs.append(q[::-1] if reverse else q)
    qsel = rng.integers(0, nq, size=b).astype(np.int32)
    t_lens = rng.integers(1, lt + 1, size=b).astype(np.int32)
    t_lens[0] = lt
    targets = np.full((lt, b), PAD, np.int8)
    for k in range(b):
        n = int(t_lens[k])
        t = rng.integers(0, 20, size=n)
        if k % 2 == 0:
            q = seqs[qsel[k]]
            w = min(len(q), n)
            frag = q[:w].copy()
            mut = rng.random(w) < 0.25
            frag[mut] = rng.integers(0, 20, size=int(mut.sum()))
            t[:w] = frag
        targets[:n, k] = t
    qoff = rng.integers(0, lq + 1, size=b).astype(np.int32)
    out = [np.ascontiguousarray(np.concatenate(profs)), targets, qsel, qoff,
           q_lens, t_lens]
    return [torch.from_numpy(a) for a in out]


def windows(prof_flat, qsel, qoff, q_lens):
    """Each lane's window end and offset (numpy), and the longest window."""
    lq = prof_flat.shape[1]
    ends = (np.full(len(qsel), lq) if q_lens is None
            else q_lens.numpy()[qsel.numpy()])
    offs = np.zeros(len(qsel), np.int64) if qoff is None else qoff.numpy()
    return ends, offs, int(max(np.maximum(ends - offs, 0).max(), 0))


def kernel_cells(prof_flat, targets, qsel, qoff, q_lens, t_lens, form, go,
                 ge):
    """(score, qend, tend) of each lane scanned on the cells the kernel
    computes in `form` alone: the rows of its strips, from the strip
    holding qoff (its rows below qoff scoring as pad, the rows past Lq pad),
    and the target's real columns."""
    lq = prof_flat.shape[1]
    ends, offs, longest = windows(prof_flat, qsel, qoff, q_lens)
    rows, _ = tg.strip_plan(form, longest)
    computed = tsw.rows_computed(form, longest, ends, offs)
    out = []
    for k in range(len(qsel)):
        if computed[k] == 0:
            out.append((0, lq - 1, -1))
            continue
        off = max(int(offs[k]), 0)
        base = off // rows * rows
        q = int(qsel[k])
        prof = torch.full((32, int(computed[k])), NEG, dtype=torch.int32)
        part = prof_flat[q * 32:(q + 1) * 32, base:base + int(computed[k])]
        prof[:, :part.shape[1]] = part
        prof[:, :off - base] = NEG
        n = int(t_lens[k])
        s, qe, te = (int(x[0]) for x in tsw.sw_multi_plain(
            prof, targets[:n, k:k + 1].contiguous(), None, None, go, ge))
        out.append((s, qe + base, te) if s > 0 else (0, lq - 1, -1))
    return [torch.tensor(c, dtype=torch.int32) for c in zip(*out)]


# (nq, lq, lt, b, min_len, layout): forward (q_lens, no offset), reverse
# (the reversed profiles, an offset, no q_lens) and both at once; the last
# two strip-mine the longest window in both forms
WINDOW_CASES = [
    (3, 40, 48, 12, 5, "forward"),
    (4, 72, 40, 16, 20, "reverse"),
    (5, 64, 36, 20, 1, "both"),
    (2, 2200, 24, 6, 1500, "forward"),
    (2, 2200, 20, 6, 1500, "reverse"),
]


@pytest.mark.parametrize("go,ge", [(11, 1), (1, 1), (13, 2)])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_plain_with_the_window_equals_every_cell_and_the_kernel_cells(case,
                                                                     go, ge):
    """sw_multi (on the CPU: its plain version) given the lengths, the
    profiles' maximum and the longest window equals the scan of every cell
    without them, and each lane scanned on the cells the kernel computes
    alone, in the strip plan of either form; lanes whose offset is on a
    strip boundary and lanes whose offset is not both occur."""
    nq, lq, lt, b, min_len, layout = case
    prof, targets, qsel, qoff, q_lens, t_lens = make_case(
        lq + lt + go, nq, lq, lt, b, min_len, reverse=layout == "reverse")
    if layout == "forward":
        qoff = None
    else:       # lane 0's window, all of profile 0's rows, is the longest
        qsel[0], qoff[0] = 0, 0
    if layout == "reverse":
        q_lens = None
    ends, offs, longest = windows(prof, qsel, qoff, q_lens)
    full = tsw.sw_multi_plain(prof, targets, qsel, qoff, go, ge)
    got = tsw.sw_multi(prof, targets, qsel, qoff, go=go, ge=ge,
                       q_lens=q_lens, t_lens=t_lens,
                       prof_max=int(prof.max()), max_window=longest)
    for g, f in zip(got, full):
        assert torch.equal(g, f)
    assert int(got[0].max()) > 0
    for form in ("int16", "int32"):
        if qoff is not None:        # one lane on a strip boundary, one off
            rows, _ = tg.strip_plan(form, longest)
            qoff = qoff.clone()
            qoff[1], qoff[2] = 2 * rows, 2 * rows + 1
            full = tsw.sw_multi_plain(prof, targets, qsel, qoff, go, ge)
        view = kernel_cells(prof, targets, qsel, qoff, q_lens, t_lens, form,
                            go, ge)
        for v, f in zip(view, full):
            assert torch.equal(v, f)


def test_offset_plain_with_the_window_equals_every_cell():
    """sw_offset, one profile: q_len ends the windows, qoff starts them."""
    prof, targets, _, qoff, q_lens, t_lens = make_case(4, 1, 60, 40, 10, 1)
    prof[:, 45:] = NEG
    full = tsw.sw_offset_plain(prof, targets, qoff)
    longest = int(np.maximum(45 - qoff.numpy(), 0).max())
    got = tsw.sw_offset(prof, targets, qoff, q_len=45, t_lens=t_lens,
                        prof_max=int(prof.max()), max_window=longest)
    for g, f in zip(got, full):
        assert torch.equal(g, f)
    assert int(got[0].max()) > 0


def test_an_empty_window_is_no_breach():
    """A lane whose offset is at or past its window's end gives
    (0, Lq - 1, -1), as does one past Lq."""
    prof, targets, qsel, qoff, q_lens, t_lens = make_case(6, 3, 32, 24, 6, 8)
    ends = q_lens[qsel.long()]
    qoff = torch.tensor([0, 0, int(ends[2]), int(ends[3]) + 1, 40, 0],
                        dtype=torch.int32)
    got = tsw.sw_multi(prof, targets, qsel, qoff, q_lens=q_lens,
                       t_lens=t_lens, prof_max=int(prof.max()),
                       max_window=int(ends.max()))
    for k in (2, 3, 4):
        assert [int(x[k]) for x in got] == [0, 31, -1]
    assert int(got[0][0]) > 0


def _breaches():
    """(name, wrapper arguments, keywords) that break the contract."""
    prof, targets, qsel, qoff, q_lens, t_lens = make_case(5, 3, 24, 20, 6, 6)
    q_lens[1] = 10
    prof[32:64, 10:] = NEG
    past_row = prof.clone()
    past_row[32 + 3, 12] = 0                # profile 1, row 12 >= 10
    pad_row = prof.clone()
    pad_row[32 + PAD, 2] = -5               # profile 1's pad letter, row 2
    late = targets.clone()
    short = t_lens.clone()
    short[0] = 10                           # lane 0 is 20 long
    ok = dict(q_lens=q_lens)
    longest = windows(prof, qsel, qoff, q_lens)[2]
    return [
        ("a real row past q_lens", (past_row, targets, qsel, qoff), ok),
        ("q_lens shape", (prof, targets, qsel, qoff),
         dict(q_lens=q_lens[:2])),
        ("q_lens above lq", (prof, targets, qsel, qoff),
         dict(q_lens=torch.full((3,), 25, dtype=torch.int32))),
        ("a real letter past t_lens", (prof, late, qsel, qoff),
         dict(ok, t_lens=short)),
        ("t_lens above lt", (prof, targets, qsel, qoff),
         dict(ok, t_lens=torch.full((6,), 21, dtype=torch.int32))),
        ("the pad letter scores on a real row", (pad_row, targets, qsel,
                                                 qoff),
         dict(ok, t_lens=t_lens)),
        ("prof_max below the largest entry", (prof, targets, qsel, qoff),
         dict(ok, prof_max=int(prof.max()) - 1)),
        ("max_window below the longest window", (prof, targets, qsel, qoff),
         dict(ok, max_window=longest - 1)),
        ("qsel outside the profiles", (prof, targets, qsel + 3, qoff), ok),
    ]


@pytest.mark.parametrize("fn", ["sw_multi", "sw_multi_plain"])
@pytest.mark.parametrize("breach", range(9))
def test_each_contract_breach_raises(fn, breach):
    name, args, kw = _breaches()[breach]
    with pytest.raises(ValueError):
        getattr(tsw, fn)(*args, **kw)


@pytest.mark.parametrize("fn", ["sw_offset", "sw_offset_plain"])
def test_sw_offset_checks_its_window(fn):
    prof, targets, _, qoff, _, t_lens = make_case(8, 1, 30, 20, 5, 30)
    prof[:, 20:] = NEG
    longest = int(np.maximum(20 - qoff.numpy(), 0).max())
    ok = dict(q_len=20, t_lens=t_lens, prof_max=int(prof.max()),
              max_window=longest)
    getattr(tsw, fn)(prof, targets, qoff, **ok)
    for bad in (dict(q_len=19), dict(max_window=longest - 1),
                dict(prof_max=int(prof.max()) - 1)):
        with pytest.raises(ValueError):
            getattr(tsw, fn)(prof, targets, qoff, **dict(ok, **bad))


# -- the form and the strip plan ----------------------------------------------

@pytest.mark.parametrize("window,prof_max,form", [
    (2978, 11, "int16"), (2979, 11, "int32"),   # the launch's longest window
    (512, 63, "int16"), (512, 64, "int32"),     # 32,256 and 32,768
    (128, 255, "int16"), (129, 255, "int32"),   # the TPU pack-limit entry
    (0, 1 << 20, "int16"),                      # every window empty
    (4096, 0, "int16"),                         # nothing positive
])
def test_pick_form_for_a_window(window, prof_max, form):
    assert tsw.pick_form(window, prof_max, 11, 1) == form


@pytest.mark.parametrize("form", ["int16", "int32"])
def test_strip_plan_covers_every_lanes_window(form):
    """rows_computed: each lane's strips start at the strip boundary at or
    below its offset, cover its window, and take the fewest chunks that do;
    an empty window takes none. A lane at most one chunk past the plan's
    count (an offset off a strip boundary)."""
    rng = np.random.default_rng(7)
    for lq in (32, 100, 512, 2048, 3000):
        q_end = rng.integers(0, lq + 1, size=200)
        qoff = rng.integers(-3, lq + 2, size=200)
        q_end[0], qoff[0] = lq, 0
        longest = int(np.maximum(q_end - np.maximum(qoff, 0), 0).max())
        rows, chunks = tg.strip_plan(form, longest)
        got = tsw.rows_computed(form, longest, q_end, qoff)
        assert got[0] == 32 * rows * chunks
        for e, o, c in zip(q_end, np.maximum(qoff, 0), got):
            if e <= o:
                assert c == 0
                continue
            base = o // rows * rows
            assert base <= o < base + rows
            assert c % (32 * rows) == 0 and base + c >= e
            assert base + c - 32 * rows < e
            assert c <= 32 * rows * (chunks + 1)


# -- the aligner ------------------------------------------------------------

def test_aligner_passes_the_lengths_and_groups_the_reverse_pass(monkeypatch):
    """The aligner against the JAX Aligner, with one query longer than a
    chunk of the widest strips (2,100 rows): equal records; each launch gets
    the forward q_lens (None in the reverse pass), the lanes' target lengths,
    the profiles' largest entry and the longest window as host ints, and the
    reverse pass's launches each hold one window bucket."""
    from mmseqs2_tpu_torch.align import aligner as taligner
    from mmseqs2_tpu_torch.data.submat import get_submat as t_get_submat
    from mmseqs2_tpu_torch.ops.encode import bucket_length
    from mmseqs2_tpu_torch.ops.evalue import EvalueComputation as TEvalue
    from test_torch_aligner import _jax_side, _run, make_jobs_data
    data = make_jobs_data(seed=5, n_queries=4, n_targets=10)
    rng = np.random.default_rng(21)
    q = rng.integers(0, 20, size=2100)
    seqs = []
    for k in range(3):
        t = q.copy()
        mut = rng.random(len(t)) < 0.3
        t[mut] = rng.integers(0, 20, size=int(mut.sum()))
        seqs.append(t[k * 200:1800 + k * 100].astype(np.int64))
    data.append((q.astype(np.int64), [900, 901, 902], seqs, [False] * 3))
    calls = []
    real = tsw.sw_multi

    def record(prof, targets, qsel, qoff=None, **kw):
        calls.append((prof, targets, qsel, qoff, kw))
        return real(prof, targets, qsel, qoff, **kw)
    monkeypatch.setattr(taligner, "sw_multi", record)
    taligner.reset_stats()
    tsub = t_get_submat("blosum62.out", 2.0, 0.0)
    _, got = _run(taligner, tsub, TEvalue, data, 2, 0, 0.0, 10.0, 0.0,
                  device="cpu")
    jaligner, j_get_submat, JEvalue = _jax_side()
    _, want = _run(jaligner, j_get_submat("blosum62.out", 2.0, 0.0), JEvalue,
                   data, 2, 0, 0.0, 10.0, 0.0)
    for gq, wq in zip(got, want):
        for g, w in zip(gq, wq):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert max(r.raw_score for r in got[-1]) > 0
    n_rev = 0
    for prof, targets, qsel, qoff, kw in calls:
        assert isinstance(kw["prof_max"], int)
        assert kw["prof_max"] == int(prof.max())
        assert torch.equal(kw["t_lens"], (targets != PAD).sum(0).int())
        assert isinstance(kw["max_window"], int)
        ends, offs, longest = windows(prof, qsel, qoff, kw["q_lens"])
        assert kw["max_window"] == longest
        if qoff is None:            # forward: the profiles' real lengths
            real_rows = (prof.reshape(-1, 32, prof.shape[1])[:, :PAD]
                         > NEG).any(1).sum(1)
            assert torch.equal(kw["q_lens"], real_rows.int())
        else:
            n_rev += 1
            assert kw["q_lens"] is None
            assert len({bucket_length(max(w, 1), taligner.BUCKET_MIN)
                        for w in ends - offs}) == 1
    assert n_rev > 1
    st = taligner.STATS
    assert 0 < st["cells_real"] <= st["cells_computed"]
    assert st["int32_launches"] == []


def test_aligner_records_the_bound_of_an_int32_launch(monkeypatch):
    """The form's bound takes the largest entry of every profile of a
    launch: one profile raised past the 16-bit score bound sends its launch
    to the int32 form, and the aligner names the bound."""
    from mmseqs2_tpu_torch.align import aligner as taligner
    from mmseqs2_tpu_torch.data.submat import get_submat as t_get_submat
    from mmseqs2_tpu_torch.ops.evalue import EvalueComputation as TEvalue
    from test_torch_aligner import make_jobs_data
    data = make_jobs_data(seed=9, n_queries=3, n_targets=4)
    tsub = t_get_submat("blosum62.out", 2.0, 0.0)
    al = taligner.Aligner(tsub, 11, 1, TEvalue(10_000, tsub, 11, 1),
                          device="cpu")
    jobs = []
    for q, keys, seqs, ident in data:
        ctx = al.init_query(q)
        jobs.append((ctx, keys, seqs, [len(s) for s in seqs], ident))
    jobs[1][0].profile[3, 0] = 1000
    taligner.reset_stats()
    al.align_batch(jobs, 0)
    bounds = taligner.STATS["int32_launches"]
    assert bounds and all(b["prof_max"] == 1000 for b in bounds)
    assert all(b["score_bound"] == b["window"] * 1000 >= 1 << 15
               for b in bounds)


def test_cpu_runs_no_kernel_and_counts_no_launch():
    prof, targets, qsel, qoff, q_lens, t_lens = make_case(9, 2, 32, 24, 4)
    wrappers = (tsw.sw_multi, tsw.sw_offset)
    before = [(w.launches, dict(w.form_launches)) for w in wrappers]
    tsw.sw_multi(prof, targets, qsel, qoff, q_lens=q_lens, t_lens=t_lens)
    tsw.sw_offset(prof[:32], targets, qoff, t_lens=t_lens)
    assert before == [(w.launches, dict(w.form_launches)) for w in wrappers]
    with pytest.raises(ValueError, match="no kernel"):
        tsw.sw_multi(prof.to("meta"), targets.to("meta"), qsel.to("meta"))


# -- the kernel (needs the card) ----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lt,b,q_len", [(72, 40, 17, 50),
                                           (512, 300, 600, 400),
                                           (2500, 200, 40, 2300)])
@pytest.mark.parametrize("form", ["picked", "int32"])
def test_sw_offset_kernel_matches_plain_with_lengths(cuda_device, lq, lt, b,
                                                     q_len, form):
    """sw_offset on the card with q_len, t_lens, prof_max and the longest
    window, in the form pick_form chooses and in the int32 form, against
    its plain version; strip-mined at Lq 2,500 in both forms."""
    prof, targets, _, qoff, _, t_lens = make_case(lq + b, 1, lq, lt, b)
    prof[:, q_len:] = NEG
    if form == "int32":
        prof[0, 0] = 40_000
    longest = int(np.maximum(q_len - qoff.numpy(), 0).max())
    kw = dict(q_len=q_len, t_lens=t_lens, prof_max=int(prof.max()),
              max_window=longest)
    want = tsw.sw_offset_plain(prof, targets, qoff, **kw)
    expect = tsw.pick_form(longest, int(prof.max()), 11, 1)
    assert (expect == "int32") == (form == "int32")
    before = dict(tsw.sw_offset.form_launches)
    dev = dict(kw, t_lens=t_lens.to(cuda_device))
    got = tsw.sw_offset(prof.to(cuda_device), targets.to(cuda_device),
                        qoff.to(cuda_device), **dev)
    torch.cuda.synchronize()
    assert tsw.sw_offset.form_launches[expect] == before[expect] + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[0].max()) > 0
