"""The port's gapless scan (mmseqs2_tpu_torch.ops.gapless) against the JAX
package: the Pallas kernel in interpret mode in both of its gapless forms,
and both packages' dp.gapless_scan. Every output is an integer, so agreement
is exact.

Kernel tests need a CUDA card and skip without one; on the CPU the wrappers
run their plain versions. JAX is imported inside the tests that compare with
it, so that the kernel tests also run where only PyTorch is installed:
    python -m pytest tests/test_torch_gapless.py -m cuda"""

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch.ops import dp as tdp
from mmseqs2_tpu_torch.ops import gapless as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(rng, alpha=32):
    m = rng.integers(-4, 3, size=(alpha, alpha))
    m = ((m + m.T) // 2).astype(np.int32)
    np.fill_diagonal(m, rng.integers(4, 12, size=alpha))
    return m


def make_case(seed, lq, lt, b, kind="random", pad_rows=0, q_len=None):
    """One (32, lq) profile and (b, lt) targets. "pallas" is the input of
    tests/test_pallas.py; "random" plants mutated fragments of the query in
    half of the lanes; "identical" makes every lane hold the query itself at
    several offsets (long runs that reach a small cap early, so the
    first-column rule decides); "negative" scores every cell below 0.
    With q_len the arrays are padded as make_query_profile and TargetStore
    pad them: rows from q_len on and the rows of the letters past the
    21-letter alphabet (the pad letter 31 among them) score -(1 << 20), and
    every lane ends in pad letters after a real length drawn in
    (lt / 2, lt] (lane 0 is full). Returns the profile, the targets and the
    targets' real lengths (None without q_len)."""
    rng = np.random.default_rng(seed)
    m = _matrix(rng)
    q = rng.integers(0, 20, size=lq)
    prof = m[q, :].T.astype(np.int32)
    targets = rng.integers(0, 20, size=(b, lt)).astype(np.int32)
    if kind == "pallas":
        targets[0, 5:40] = q[3:38]
    elif kind == "random":
        for k in range(0, b, 2):
            n = int(rng.integers(8, min(lq, lt) - 4))
            qs = int(rng.integers(0, lq - n))
            ts = int(rng.integers(0, lt - n))
            frag = q[qs:qs + n].copy()
            mut = rng.random(n) < 0.2
            frag[mut] = rng.integers(0, 20, size=int(mut.sum()))
            targets[k, ts:ts + n] = frag
    elif kind == "identical":
        n = min(lq, lt) - 8
        for k in range(b):
            targets[k, k % 8:k % 8 + n] = q[:n]
    elif kind == "negative":
        prof = -1 - np.abs(prof)
    if pad_rows:
        prof[:, lq - pad_rows:] = tg.NEG
    t_lens = None
    if q_len is not None:
        prof[:, q_len:] = tg.NEG
        prof[21:, :] = tg.NEG
        t_lens = rng.integers(lt // 2 + 1, lt + 1, size=b).astype(np.int32)
        t_lens[0] = lt
        for k in range(b):
            targets[k, t_lens[k]:] = tg.PAD_LETTER
    return np.ascontiguousarray(prof), targets, t_lens


def port(fn, prof, targets, cap, device="cpu", q_len=None, t_lens=None):
    kw = {}
    if q_len is not None:
        kw["q_len"] = q_len
    if t_lens is not None:
        kw["t_lens"] = torch.from_numpy(t_lens).to(device)
    out = fn(torch.from_numpy(prof).to(device),
             torch.from_numpy(np.ascontiguousarray(
                 targets.T.astype(np.int8))).to(device), cap, **kw)
    if isinstance(out, tuple):
        return [o.cpu().numpy() for o in out]
    return out.cpu().numpy()


# (seed, lq, lt, b, kind, cap, pad_rows, q_len); q_len None passes no
# lengths (the JAX layout as it is), an int passes q_len and the targets'
# real lengths to the port. The JAX side never gets lengths. The Pallas
# comparison runs in interpret mode, so the shapes stay as small as
# tests/test_pallas.py's
CASES = {
    "test_pallas input, cap 250": (3, 64, 96, 8, "pallas", 250, 0, None),
    "cap 255 - 4": (11, 64, 96, 8, "random", 251, 0, None),
    "cap 255 - 60": (12, 64, 80, 8, "random", 195, 0, None),
    "small cap, many cells reach it": (13, 64, 96, 16, "identical", 40, 0,
                                       None),
    "all-negative": (14, 64, 96, 8, "negative", 250, 0, None),
    "lq 50, no multiple of 8": (15, 50, 72, 8, "random", 250, 0, None),
    "pad rows": (16, 72, 56, 8, "random", 250, 9, None),
    "lengths, q_len 45 of 64": (21, 64, 96, 8, "random", 250, 0, 45),
    "lengths, q_len = Lq 64": (22, 64, 80, 8, "random", 251, 0, 64),
    "lengths, small cap": (23, 64, 96, 16, "identical", 40, 0, 50),
    "lengths, all-negative": (24, 64, 96, 8, "negative", 250, 0, 40),
    "lengths, q_len 33 of 50": (25, 50, 72, 8, "random", 195, 0, 33),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gapless_plain_matches_pallas_and_dp(name):
    """Tracking form: sw_pallas(gapless=True) in interpret mode and both
    packages' dp.gapless_scan(with_endpos=True)."""
    from mmseqs2_tpu.ops import dp as jdp
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas
    seed, lq, lt, b, kind, cap, pad_rows, q_len = CASES[name]
    prof, targets, t_lens = make_case(seed, lq, lt, b, kind, pad_rows, q_len)
    got = port(tg.gapless, prof, targets, cap, q_len=q_len, t_lens=t_lens)
    want = [np.asarray(x) for x in sw_pallas(
        prof, targets.T.astype(np.int8), gapless=True, cap=cap,
        interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    qidx = np.zeros(b, np.int32)
    caps = np.full(b, cap, np.int32)
    want = jdp.gapless_scan(prof[None], qidx, targets, caps,
                            with_endpos=True)
    mine = tdp.gapless_scan(prof[None], qidx, targets, caps,
                            with_endpos=True)
    for g, w, m in zip(got, want, mine):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, m.numpy())
    if kind == "negative":
        assert (got[0] == 0).all() and (got[2] == -1).all()
        assert (got[1] == lq - 1).all()
    else:
        assert got[0].max() > 0
    if kind == "identical":
        assert (got[0] == cap).all()        # saturated in every lane


@pytest.mark.parametrize("name", sorted(CASES))
def test_gapless_score_plain_matches_pallas(name):
    """Score-only form: gapless_pallas_score in interpret mode; the cap at
    the end gives the tracking form's score."""
    from mmseqs2_tpu.ops.pallas_sw import gapless_pallas_score
    seed, lq, lt, b, kind, cap, pad_rows, q_len = CASES[name]
    prof, targets, t_lens = make_case(seed, lq, lt, b, kind, pad_rows, q_len)
    got = port(tg.gapless_score, prof, targets, cap, q_len=q_len,
               t_lens=t_lens)
    want = np.asarray(gapless_pallas_score(
        prof, targets.T.astype(np.int8), cap=cap, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port(tg.gapless, prof, targets,
                                            cap)[0])


def test_gapless_cpu_uses_plain_versions_and_checks_inputs():
    prof, targets, _ = make_case(1, 32, 40, 6)
    before = tg.gapless.launches, tg.gapless_score.launches
    port(tg.gapless, prof, targets, 250)
    port(tg.gapless_score, prof, targets, 250)
    assert (tg.gapless.launches, tg.gapless_score.launches) == before
    with pytest.raises(ValueError):         # not (32, Lq)
        tg.gapless(torch.zeros((31, 8), dtype=torch.int32),
                   torch.zeros((4, 2), dtype=torch.int8))
    with pytest.raises(ValueError):         # targets not (Lt, B)
        tg.gapless_score(torch.zeros((32, 8), dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int8))
    with pytest.raises(ValueError):         # no kernel for this device
        tg.gapless(torch.zeros((32, 8), dtype=torch.int32, device="meta"),
                   torch.zeros((4, 2), dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("fn", [tg.gapless, tg.gapless_score],
                         ids=["gapless", "gapless_score"])
@pytest.mark.parametrize("breach", [
    "positive cell past q_len", "real letter past t_lens",
    "pad letter scored on a real row", "t_lens past Lt", "q_len past Lq",
    "prof_max below the largest entry"])
def test_gapless_plain_checks_the_lengths_contract(fn, breach):
    """The plain versions hold the caller to the lengths' contract: where it
    breaks, skipping cells would change the result, so they raise."""
    prof, targets, t_lens = make_case(31, 64, 48, 6, q_len=40)
    port(fn, prof, targets, 250, q_len=40, t_lens=t_lens)   # holds
    q_len, prof_max = 40, None
    if breach == "positive cell past q_len":
        prof[3, 50] = 2
    elif breach == "real letter past t_lens":
        k = int(np.argmin(t_lens))
        assert t_lens[k] < targets.shape[1]
        targets[k, t_lens[k]] = 5
    elif breach == "pad letter scored on a real row":
        prof[tg.PAD_LETTER, 10] = 0
    elif breach == "t_lens past Lt":
        t_lens = t_lens.copy()
        t_lens[1] = 49
    elif breach == "q_len past Lq":
        q_len = 65
    else:
        prof_max = int(prof.max()) - 1
    with pytest.raises(ValueError):
        fn(torch.from_numpy(prof), torch.from_numpy(np.ascontiguousarray(
            targets.T.astype(np.int8))), 250, q_len=q_len,
           t_lens=torch.from_numpy(t_lens), prof_max=prof_max)


@pytest.mark.parametrize("cap,prof_max,form", [
    (255 - 4, 11, "int16"), (255 - 100, 15, "int16"), (251, 255, "int16"),
    (5000, 11, "int16"), (0, 11, "int16"), (32767 - 11, 11, "int16"),
    (32768 - 11, 11, "int32"), (40_000, 11, "int32"), (251, 32_000, "int16"),
    (1000, 32_000, "int32"),
    (-1, 11, "int32")])
def test_pick_form_by_input_range(cap, prof_max, form):
    """The 16-bit form wherever cap + the largest entry stays below 2^15
    (the commands' caps are 255 - bias), the int32 form otherwise."""
    assert tg.pick_form(cap, prof_max) == form


@pytest.mark.parametrize("form", ["int16", "int32"])
def test_strip_plan_covers_the_query_in_the_fewest_chunks(form):
    top = tg.ROWS[form][-1]
    for q_len in [0, 1, 31, 32, 33, 64, 100, 257, 300, 512, 1000, 1024, 1025,
                  2047, 2048, 2049, 2300, 2500, 4096, 5000]:
        rows, chunks = tg.strip_plan(form, q_len)
        assert rows in tg.ROWS[form]
        assert chunks == -(-max(q_len, 1) // (32 * top))
        covered = tg.rows_computed(form, q_len)
        assert covered == 32 * rows * chunks >= q_len
        smaller = [r for r in tg.ROWS[form] if r < rows]
        assert not smaller or 32 * smaller[-1] * chunks < q_len


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lt,b,kind,cap,pad_rows,q_len", [
    (32, 40, 8, "random", 250, 0, None), (50, 72, 9, "random", 251, 3, None),
    (512, 300, 600, "random", 195, 40, None),
    (256, 512, 300, "identical", 40, 0, None),
    (128, 256, 64, "negative", 250, 0, None),
    (2500, 200, 40, "random", 250, 100, None),
    (2048, 160, 33, "identical", 5000, 0, None),
    (512, 300, 600, "random", 195, 0, 400),
    (256, 512, 300, "identical", 40, 0, 256),
    (128, 256, 64, "negative", 250, 0, 100),
    (2500, 200, 40, "random", 250, 0, 2300),
    (512, 300, 200, "random", 40_000, 0, 400),
    (2500, 200, 40, "random", 40_000, 0, 2300),
    (2500, 200, 40, "random", 40_000, 100, None)])
def test_gapless_kernels_match_plain(cuda_device, lq, lt, b, kind, cap,
                                     pad_rows, q_len):
    """Both kinds of the kernel (gapless, gapless_score) against their plain
    versions (run on the CPU) and against each other, in the form the input
    picks (int16 below cap 32,768 - the largest entry, int32 at cap 40,000),
    with and without the real lengths."""
    prof, targets, t_lens = make_case(lq, lq, lt, b, kind, pad_rows, q_len)
    kw = dict(q_len=q_len, t_lens=t_lens)
    want = port(tg.gapless, prof, targets, cap, **kw)
    want_s = port(tg.gapless_score, prof, targets, cap, **kw)
    form = tg.pick_form(cap, prof.max())
    before = [(w.launches, w.form_launches[form])
              for w in (tg.gapless, tg.gapless_score)]
    got = port(tg.gapless, prof, targets, cap, cuda_device, **kw)
    got_s = port(tg.gapless_score, prof, targets, cap, cuda_device, **kw)
    assert [(w.launches, w.form_launches[form])
            for w in (tg.gapless, tg.gapless_score)] == \
        [(n + 1, f + 1) for n, f in before]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_s, got[0])
