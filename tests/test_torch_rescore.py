"""The port's ungapped diagonal rescore (mmseqs2_tpu_torch.ops.rescore)
against the JAX package's rescorers (device_stages.make_rescore and
make_rescore_from_letters, on the CPU) and against a plain Kadane loop in
numpy, with and without the valid count; and a numpy model of the CUDA
kernel's decomposition (aligned word loads joined by a funnel shift, runs of
K cells per lane, the cells past a window scored 0, groups of G lanes
combined by an exclusive sum-scan and a min-scan, carries between passes)
against the same loop, at the kernel's G = 8 and K = 16. The profile form
(diag_rescore_profile: a cell's score read from its query's int8 profile
row) against a Kadane loop over the profile, the JAX package's
device_stages.make_rescore, and the letters form on the profile that a
query's letters and corrections make; and a numpy model of the profile
kernel's schedule (its warp batches, each lane's run of 16 scores read
from their rows, the passes and scans) against the plain version, on
slots sorted by (query, target) and not. Every output is an
integer: tolerance 0.

The card tests (the kernel against its plain version, and a whole flush of
the prefilter's device stages against the same flush on the CPU) need a
CUDA card and skip without one; on the CPU the wrapper runs its plain
version. JAX is imported inside the tests that compare with it, so the card
tests also run where only PyTorch is installed:
    python -m pytest tests/test_torch_rescore.py -m cuda"""

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import PACKAGE_DIR
from mmseqs2_tpu_torch.ops import rescore as tr

I32_MAX = 2147483647
ALPHA = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, n_t=40, n_q=6, lq=96, n_cand=300, tmax=140,
              negative=False, planted=True):
    """A random target store, query batch and candidate list, as numpy
    arrays in the wrapper's argument order. Candidates cover windows of
    length 0, 1 and the whole query, both signs of the diagonal, the
    extremes of the signed 16-bit range, planted identical segments (scores
    past 255) and invalid slots (qid and id I32_MAX)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-4, 2, size=(ALPHA, ALPHA))
    m = ((m + m.T) // 2).astype(np.int32)
    np.fill_diagonal(m, rng.integers(4, 12, size=ALPHA))
    if negative:
        m = -1 - np.abs(m)
    q_len = rng.integers(1, lq + 1, size=n_q).astype(np.int32)
    q_len[0], q_len[-1] = lq, 1
    q_pad = np.full((n_q, lq), ALPHA - 1, np.uint8)
    corr = np.zeros((n_q, lq), np.int8)
    for b in range(n_q):
        q_pad[b, :q_len[b]] = rng.integers(0, ALPHA - 1, size=q_len[b])
        corr[b, :q_len[b]] = rng.integers(-3, 1 if negative else 4,
                                          size=q_len[b])
    t_len = rng.integers(1, tmax + 1, size=n_t).astype(np.int32)
    t_len[0], t_len[1] = 1, tmax
    seqs = [rng.integers(0, ALPHA - 1, size=n).astype(np.int8)
            for n in t_len]
    cqid = rng.integers(0, n_q, size=n_cand).astype(np.int32)
    cid = rng.integers(0, n_t, size=n_cand).astype(np.int32)
    d = np.array([int(rng.integers(-int(t_len[i]) - 2, int(q_len[b]) + 2))
                  for b, i in zip(cqid, cid)])
    if planted:
        # the whole of query 0 inside target 1, on diagonal -7
        seqs[1][7:7 + min(lq, tmax - 7)] = q_pad[0, :min(lq, tmax - 7)]
        cqid[:4], cid[:4], d[:4] = 0, 1, (-7, -7, 0, 5)
    d[4:8] = (-32768, 32767, -1, 1)
    cqid[8], cid[8], d[8] = n_q - 1, 0, 0           # a 1-cell window
    cvalid = rng.random(n_cand) < 0.85
    cvalid[:9] = True
    cqid[~cvalid] = I32_MAX
    cid[~cvalid] = I32_MAX
    t_off = np.concatenate([[0], np.cumsum(t_len[:-1])]).astype(np.int64)
    return (cqid, cid, (d & 0xFFFF).astype(np.int32), cvalid,
            np.concatenate(seqs), t_off, t_len, q_pad, corr, m, q_len)


def kadane(case):
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, m, q_len = \
        case
    out = np.zeros(len(cqid), np.int64)
    for c in np.nonzero(cvalid)[0]:
        d = int(np.int16(np.uint16(cdiag[c])))
        qs, ts = max(d, 0), max(-d, 0)
        b, i = cqid[c], cid[c]
        run = 0
        for l in range(max(min(t_len[i] - ts, q_len[b] - qs), 0)):
            run = max(run, 0) + int(m[q_pad[b, qs + l],
                                      t_cat[t_off[i] + ts + l]]) \
                + int(corr[b, qs + l])
            out[c] = max(out[c], run)
    return out


def as_torch(case, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in case]


CASES = {
    "mixed": dict(seed=1),
    "long-windows": dict(seed=2, lq=300, tmax=400, n_cand=200),
    "all-negative": dict(seed=3, negative=True, planted=False),
    "single-query": dict(seed=4, n_q=2, n_t=3, n_cand=64),
    "many-candidates": dict(seed=5, n_cand=3000, n_t=200),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_kadane_loop(name):
    case = make_case(**CASES[name])
    got = tr.diag_rescore_plain(*as_torch(case)).numpy()
    want = kadane(case)
    assert np.array_equal(got, want)
    assert (got[~case[3]] == 0).all()
    if CASES[name].get("negative"):
        assert (got == 0).all()
    if CASES[name].get("planted", True):
        assert got[0] > 255 and got[0] == got[1]


@pytest.mark.parametrize("from_letters", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_rescore(name, from_letters):
    import jax.numpy as jnp
    from mmseqs2_tpu.prefilter import device_stages as jds
    case = make_case(**CASES[name])
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, m, q_len = \
        case
    lq = q_pad.shape[1]
    ln = jds.bucket(max(lq, int(t_len.max())), 64)
    store = (jnp.asarray(t_cat), jnp.asarray(t_off.astype(np.int32)),
             jnp.asarray(t_len))
    kw = dict(lq_max=lq, ln_max=ln, chunk=128)
    if from_letters:
        rescore = jds.make_rescore_from_letters(
            *store, jnp.asarray(q_pad.astype(np.int32)),
            jnp.asarray(corr.astype(np.int32)), jnp.asarray(m),
            jnp.asarray(q_len), **kw)
    else:
        prof = m[q_pad.astype(np.int64)] + corr.astype(np.int32)[:, :, None]
        rescore = jds.make_rescore(*store, jnp.asarray(prof),
                                   jnp.asarray(q_len), **kw)
    args = [jnp.asarray(a) for a in (cqid, cid, cdiag, cvalid)]
    exact = np.asarray(rescore(*args, cap=False))
    capped = np.asarray(rescore(*args, cap=True))
    got = tr.diag_rescore_plain(*as_torch(case)).numpy()
    assert np.array_equal(got, exact)
    assert np.array_equal(np.minimum(got, 255), capped)


def test_cpu_wrapper_runs_plain_version_and_checks_inputs():
    case = make_case(seed=6)
    args = as_torch(case)
    before = tr.diag_rescore.launches
    got = tr.diag_rescore(*args)
    assert tr.diag_rescore.launches == before          # no kernel on the CPU
    assert torch.equal(got, tr.diag_rescore_plain(*args))
    assert got.dtype == torch.int32 and got.shape == (len(case[0]),)
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(TypeError, match="cdiag"):
        tr.diag_rescore(*bad)
    bad = list(args)
    bad[7] = bad[7].T
    with pytest.raises(ValueError):
        tr.diag_rescore(*bad)
    bad = list(args)
    bad[9] = torch.zeros((40, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="submat"):
        tr.diag_rescore(*bad)
    empty = [a[:0] if i < 4 else a for i, a in enumerate(args)]
    assert tr.diag_rescore(*empty).shape == (0,)


@pytest.mark.parametrize("count", ["zero", "all", "cvalid-past-count"])
def test_plain_takes_the_valid_count(count):
    """n_valid as the reference's: slots at and past it give 0 whatever
    cvalid says, slots before it obey cvalid."""
    case = list(make_case(seed=7, n_cand=400))
    n = len(case[0])
    k = dict(zero=0, all=n, **{"cvalid-past-count": 250})[count]
    if count == "cvalid-past-count":
        # valid candidates past the count, as a caller's stale mask
        case[3] = case[3].copy()
        case[3][k:k + 60] = True
        case[0] = np.where(case[3], case[0] % 6, I32_MAX).astype(np.int32)
        case[1] = np.where(case[3], case[1] % 40, I32_MAX).astype(np.int32)
    args = as_torch(case)
    want = kadane(case)
    want[k:] = 0
    for shape in ((), (1,)):
        nv = torch.full(shape, k, dtype=torch.int32)
        got = tr.diag_rescore_plain(*args, nv).numpy()
        assert np.array_equal(got, want)
        assert torch.equal(tr.diag_rescore(*args, nv), torch.from_numpy(got))
    if count == "cvalid-past-count":
        assert want[:k].any() and kadane(case)[k:].any()


def test_valid_count_is_checked():
    args = as_torch(make_case(seed=6, n_cand=50))
    for bad, err in ((torch.tensor(5, dtype=torch.int64), TypeError),
                     (torch.tensor([5, 6], dtype=torch.int32), ValueError),
                     (torch.tensor([[5]], dtype=torch.int32), ValueError),
                     (torch.zeros(1, dtype=torch.int32, device="meta"),
                      ValueError),
                     (5, TypeError)):
        with pytest.raises(err, match="n_valid"):
            tr.diag_rescore(*args, bad)


def test_window_cells():
    case = make_case(seed=8, n_cand=200)
    cqid, cid, cdiag, cvalid, _, _, t_len, _, _, _, q_len = case
    got = tr.window_cells(*as_torch((cqid, cid, cdiag, cvalid, t_len,
                                     q_len)),
                          torch.tensor(150, dtype=torch.int32)).numpy()
    for c in range(len(cqid)):
        if not cvalid[c] or c >= 150:
            assert got[c] == -1
            continue
        d = int(np.int16(np.uint16(cdiag[c])))
        n = min(t_len[cid[c]] - max(-d, 0), q_len[cqid[c]] - max(d, 0))
        assert got[c] == max(n, 0)


# -- the profile form ----------------------------------------------------------

def make_profile_case(seed, **kw):
    """make_case's candidates and target store with a random int8 profile
    per query in the PSSM/4 range ([-32, 31] on the 20 amino-acid columns,
    the X column 0, zero past column 21 and past the query's length); query
    0's rows favour its letters, which make_case plants in target 1, so the
    planted windows score past 255. In diag_rescore_profile's order."""
    case = make_case(seed, **kw)
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, _, _, q_len = case
    rng = np.random.default_rng(seed + 100)
    n_q, lq = q_pad.shape
    rows = rng.integers(-32, 32, size=(n_q, lq, ALPHA))
    rows[:, :, ALPHA - 1] = 0
    rows[0, np.arange(lq), q_pad[0]] = 25
    prof = np.zeros((n_q, lq, tr.PROFILE_WIDTH), np.int8)
    for b in range(n_q):
        prof[b, :q_len[b]] = tr.profile_rows(rows[b, :q_len[b]])
    return (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len)


def kadane_profile(case):
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len = case
    out = np.zeros(len(cqid), np.int64)
    for c in np.nonzero(cvalid)[0]:
        d = int(np.int16(np.uint16(cdiag[c])))
        qs, ts = max(d, 0), max(-d, 0)
        b, i = cqid[c], cid[c]
        run = 0
        for l in range(max(min(t_len[i] - ts, q_len[b] - qs), 0)):
            run = max(run, 0) + int(prof[b, qs + l,
                                         t_cat[t_off[i] + ts + l]])
            out[c] = max(out[c], run)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_profile_plain_matches_kadane_loop(name):
    case = make_profile_case(**CASES[name])
    got = tr.diag_rescore_profile_plain(*as_torch(case)).numpy()
    assert np.array_equal(got, kadane_profile(case))
    assert (got[~case[3]] == 0).all()
    if CASES[name].get("planted", True):
        assert got[0] > 255 and got[0] == got[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_profile_plain_matches_jax_make_rescore(name):
    """The JAX package's rescorer of profile queries (make_rescore under
    _chunked_rescore, XLA on the CPU) on the same (B, Lq, 21) profile."""
    import jax.numpy as jnp
    from mmseqs2_tpu.prefilter import device_stages as jds
    case = make_profile_case(**CASES[name])
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len = case
    lq = prof.shape[1]
    ln = jds.bucket(max(lq, int(t_len.max())), 64)
    rescore = jds.make_rescore(
        jnp.asarray(t_cat), jnp.asarray(t_off.astype(np.int32)),
        jnp.asarray(t_len), jnp.asarray(prof[:, :, :ALPHA].astype(np.int32)),
        jnp.asarray(q_len), lq_max=lq, ln_max=ln, chunk=128)
    args = [jnp.asarray(a) for a in (cqid, cid, cdiag, cvalid)]
    exact = np.asarray(rescore(*args, cap=False))
    capped = np.asarray(rescore(*args, cap=True))
    got = tr.diag_rescore_profile_plain(*as_torch(case)).numpy()
    assert np.array_equal(got, exact)
    assert np.array_equal(np.minimum(got, 255), capped)


def test_profile_form_of_the_letters_equals_the_letters_form():
    """The profile a query's letters and corrections make (submat rows plus
    the correction) rescores as the letters form does."""
    case = make_case(seed=1)
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, m, q_len = \
        case
    prof = np.zeros(q_pad.shape + (tr.PROFILE_WIDTH,), np.int8)
    for b in range(len(q_len)):
        prof[b] = tr.profile_rows(m[q_pad[b].astype(np.int64)]
                                  + corr[b].astype(np.int32)[:, None])
    got = tr.diag_rescore_profile(*as_torch(
        (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len)))
    assert torch.equal(got, tr.diag_rescore(*as_torch(case)))


@pytest.mark.parametrize("count", ["zero", "all", "cvalid-past-count"])
def test_profile_plain_takes_the_valid_count(count):
    case = list(make_profile_case(seed=7, n_cand=400))
    n = len(case[0])
    k = dict(zero=0, all=n, **{"cvalid-past-count": 250})[count]
    if count == "cvalid-past-count":
        case[3] = case[3].copy()
        case[3][k:k + 60] = True
        case[0] = np.where(case[3], case[0] % 6, I32_MAX).astype(np.int32)
        case[1] = np.where(case[3], case[1] % 40, I32_MAX).astype(np.int32)
    want = kadane_profile(case)
    want[k:] = 0
    for shape in ((), (1,)):
        nv = torch.full(shape, k, dtype=torch.int32)
        got = tr.diag_rescore_profile(*as_torch(case), nv).numpy()
        assert np.array_equal(got, want)
    if count == "cvalid-past-count":
        assert want[:k].any() and kadane_profile(case)[k:].any()


def test_profile_wrapper_checks_its_inputs():
    case = make_profile_case(seed=6, n_cand=50)
    args = as_torch(case)
    before = tr.diag_rescore_profile.launches
    got = tr.diag_rescore_profile(*args)
    assert tr.diag_rescore_profile.launches == before   # the plain version
    assert got.dtype == torch.int32 and got.shape == (50,)
    bad = list(args)
    bad[7] = bad[7][:, :, :21].contiguous()
    with pytest.raises(ValueError, match="prof"):
        tr.diag_rescore_profile(*bad)
    bad = list(args)
    bad[7] = bad[7].to(torch.int32)
    with pytest.raises(TypeError, match="prof"):
        tr.diag_rescore_profile(*bad)
    bad = list(args)
    bad[8] = bad[8][:-1]
    with pytest.raises(ValueError, match="q_len"):
        tr.diag_rescore_profile(*bad)
    with pytest.raises(TypeError, match="n_valid"):
        tr.diag_rescore_profile(*args, 5)


def test_profile_rows_never_clamp():
    rows = np.array([[-128, 127, 0], [5, -6, 7]])
    got = tr.profile_rows(rows)
    assert got.shape == (2, tr.PROFILE_WIDTH) and got.dtype == np.int8
    assert np.array_equal(got[:, :3], rows) and not got[:, 3:].any()
    for v in (128, -129):
        with pytest.raises(ValueError, match="int8"):
            tr.profile_rows(np.array([[0, v]]))
    with pytest.raises(ValueError):
        tr.profile_rows(np.zeros((3, 33), np.int64))


# -- a model of the CUDA kernel's decomposition -------------------------------

# csrc/rescore.cu's G (lanes a candidate) and K (cells a lane)
G, K = 8, 16
# windows at the edges of a lane's run and of a group's pass
BOUNDARY_LENGTHS = (0, 1, K - 1, K, K + 1, G * K - 1, G * K, G * K + 1,
                    3 * G * K + 5)


def test_the_model_has_the_kernels_design():
    text = (PACKAGE_DIR / "csrc" / "rescore.cu").read_text()
    assert f"constexpr int G = {G};" in text
    assert f"constexpr int K = {K};" in text


def model_words(mem, base, size, addr, nw):
    """load_run: nw words holding the bytes at absolute address `addr`
    from aligned words of the tensor [base, base + size) in `mem` (a dict
    address -> byte), joined by __funnelshift_r; bytes outside the tensor
    read as 0, and are never reached for a cell."""
    w0, sh = addr & ~3, (addr & 3) * 8
    r = []
    for i in range(nw + 1):
        v = 0
        for b in range(4):
            a = w0 + 4 * i + b
            if base <= a < base + size:
                v |= mem[a] << (8 * b)
        r.append(v)
    return [((r[i + 1] << 32 | r[i]) >> sh) & 0xFFFFFFFF for i in range(nw)]


def model_window(g, k, n, t, q, cr, m, extra_passes=1):
    """The kernel's score of one window of n cells. t, q, cr: (mem, base,
    size, addr) of the target bytes, query letters and corrections;
    extra_passes: idle passes after the window's own (a warp runs as many
    passes as its longest window)."""
    def byte(words, i, signed=False):
        v = (words[i >> 2] >> (8 * (i & 3))) & 0xFF
        return v - 256 if signed and v > 127 else v
    carry_sum = carry_min = best = 0
    n_pass = -(-n // (g * k)) + extra_passes
    for p in range(n_pass):
        summ = []
        for j in range(g):
            o = p * g * k + j * k
            kk = min(max(n - o, 0), k)
            S = maxc = h = b = 0
            if kk:
                tw, qw, cw = (model_words(mem, base, size, addr + o, k // 4)
                              for mem, base, size, addr in (t, q, cr))
                for i in range(k):
                    # cells past the window score 0, as in the kernel
                    s = int(m[byte(qw, i), byte(tw, i)]) \
                        + byte(cw, i, True) if i < kk else 0
                    S += s
                    maxc = max(maxc, S)
                    h = max(h + s, s)
                    b = max(b, h)
            summ.append((kk, S, maxc, h, b))
        incl = np.cumsum([x[1] for x in summ]).tolist()
        ms = []
        for j, (kk, S, maxc, h, b) in enumerate(summ):
            P = carry_sum + incl[j] - S
            ms.append(P + S - max(h, 0))
            gmin = min([carry_min] + ms[:-1])
            if kk:
                best = max(best, b, maxc + P - gmin)
        carry_sum += incl[-1]
        carry_min = min([carry_min] + ms)
    return best


def window_kadane(n, t, q, cr, m):
    best = run = 0
    for i in range(n):
        s = int(m[q[0][q[3] + i], t[0][t[3] + i]]) \
            + int(np.int8(np.uint8(cr[0][cr[3] + i])))
        run = max(run, 0) + s
        best = max(best, run)
    return best


@pytest.mark.parametrize("n", BOUNDARY_LENGTHS)
@pytest.mark.parametrize("kind", ["planted", "random", "all-negative"])
def test_kernel_model_matches_kadane(kind, n):
    """The decomposition at the kernel's (G, K) on a window of n cells
    (0, 1, K - 1, K, K + 1, G K - 1, G K, G K + 1 and several G K), with
    the target window at every alignment modulo 16."""
    rng = np.random.default_rng(1000 * n + len(kind))
    mtx = rng.integers(-5, 3, size=(ALPHA, ALPHA))
    mtx = (mtx + mtx.T) // 2
    np.fill_diagonal(mtx, rng.integers(4, 12, size=ALPHA))
    if kind == "all-negative":
        mtx = -1 - np.abs(mtx)
    for align in range(16):
        # the tensors as they lie in memory: a target store starting at
        # a 16-byte boundary with the window at `align`, a query row and
        # its corrections at their own alignments; the window reaches
        # the end of the target store, as the last target's does
        t_base, t_start = 4096, 4096 + 32 + align
        t_size = t_start - t_base + n
        q_base, qs = 8192, int(rng.integers(0, 7))
        c_base = 16384 + int(rng.integers(0, 4))
        q_size = qs + n + int(rng.integers(0, 3))
        tl = rng.integers(0, ALPHA - 1, size=t_size)
        ql = rng.integers(0, ALPHA - 1, size=q_size)
        if kind == "planted":
            # a segment that starts inside the window, in any lane
            a = int(rng.integers(0, n // 2 + 1))
            e = int(rng.integers(a, n + 1))
            ql[qs + a:qs + e] = tl[t_start - t_base + a:
                                   t_start - t_base + e]
        cl = rng.integers(-3, 1 if kind == "all-negative" else 4,
                          size=q_size).astype(np.int8).view(np.uint8)
        mem = {}
        for base, arr in ((t_base, tl), (q_base, ql), (c_base, cl)):
            mem.update(zip(range(base, base + len(arr)),
                           (int(x) for x in arr)))
        t = (mem, t_base, t_size, t_start)
        q = (mem, q_base, q_size, q_base + qs)
        cr = (mem, c_base, q_size, c_base + qs)
        want = window_kadane(n, (tl, 0, 0, t_start - t_base),
                             (ql, 0, 0, qs), (cl, 0, 0, qs), mtx)
        got = model_window(G, K, n, t, q, cr, mtx)
        assert got == want, (n, align)
        if kind == "all-negative":
            assert got == 0


# -- a model of the profile kernel's schedule ---------------------------------

# csrc/rescore.cu: threads a block; candidates a warp scores at once
THREADS, NPW = 256, 32 // G


def test_the_profile_model_has_the_kernels_design():
    text = (PACKAGE_DIR / "csrc" / "rescore.cu").read_text()
    assert f"#define THREADS {THREADS}" in text
    # one body, the forms differing in how a lane gets its run's scores
    assert "rescore_body<true>(a, nullptr, valid_count(a));" in text
    assert "rescore_body<false>(a, lut, n_eff);" in text
    # a cell's score a signed byte of its row; the profile form one pass
    # of the window loop at a time
    assert "(int)__ldg(r8 + k * PROW + (tw & 31))" in text
    assert "#pragma unroll (PROFILE ? 1 : 2)" in text


def model_pass(s, base, carry_sum, carry_min):
    """One pass of a group over cells [base, base + G K) of a window, from
    the scores its lanes' runs hold (s[base + j K + k] for lane j): each
    run summarised (sum, largest prefix sum, Kadane state, best), combined
    by the exclusive sum-scan and the min-scan. Returns (the lanes' best,
    carry_sum, carry_min)."""
    best, incl, ms = 0, carry_sum, []
    for j in range(G):
        run = s[base + j * K:base + (j + 1) * K]
        S = maxc = h = b = 0
        for v in run:
            S += int(v)
            maxc = max(maxc, S)
            h = max(h, 0) + int(v)
            b = max(b, h)
        P = incl
        incl += S
        gmin = min([carry_min] + ms)
        ms.append(P + S - max(h, 0))
        if len(run):
            best = max(best, b, maxc + P - gmin)
    return best, incl, min([carry_min] + ms)


def model_profile_kernel(case, grid, n_valid=None):
    """rescore_profile_kernel's schedule on `grid` blocks: each warp takes
    batches of B consecutive slots (B doubled from 4 up to 32 while every
    warp still gets a batch) by a grid-stride loop and scores their valid
    windows NPW at a time, a group of G lanes a window, in passes of G K
    cells, each lane reading its run's 16 scores from their rows (the
    cells past the window scoring 0). Returns the scores and counts of what
    the schedule met."""
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len = case
    n_cand = len(cqid)
    n_eff = n_cand if n_valid is None else min(max(n_valid, 0), n_cand)
    n_warps = grid * THREADS // 32
    b = NPW
    while b < 32 and n_eff >= 2 * b * n_warps:
        b *= 2
    out = np.full(n_cand, -1, np.int64)
    out[n_eff:] = 0
    seen = dict(one_query=0, mixed=0, passes=0, long_windows=0)
    for w in range(n_warps):
        for c0 in range(w * b, n_eff, n_warps * b):
            slots = [c for c in range(c0, min(c0 + b, n_eff)) if cvalid[c]]
            out[[c for c in range(c0, min(c0 + b, n_eff))
                 if not cvalid[c]]] = 0
            mixed = len({int(cqid[c]) for c in slots}) > 1
            seen["mixed" if mixed else "one_query"] += 1
            for c in slots:
                d = int(np.int16(np.uint16(cdiag[c] & 0xFFFF)))
                qs, ts = max(d, 0), max(-d, 0)
                n = max(min(int(t_len[cid[c]]) - ts,
                            int(q_len[cqid[c]]) - qs), 0)
                t = int(t_off[cid[c]]) + ts
                n_pass = -(-n // (G * K))
                seen["long_windows"] += n_pass > 2
                carry_sum = carry_min = best = 0
                for p in range(n_pass):
                    base = p * G * K
                    cells = min(G * K, n - base)
                    letters = np.zeros(G * K, np.int64)
                    letters[:cells] = t_cat[t + base:t + base + cells]
                    rows = np.zeros((G * K, 32), np.int64)
                    rows[:cells] = prof[cqid[c], qs + base:qs + base + cells]
                    # lane j reads cells [j K, j K + K): row and letter
                    sc = np.concatenate(
                        [rows[j * K + np.arange(K), letters[j * K:(j + 1) * K]
                              & 31] for j in range(G)])
                    sc[cells:] = 0
                    full = np.zeros(base + G * K, np.int64)
                    full[base:] = sc
                    pb, carry_sum, carry_min = model_pass(
                        full, base, carry_sum, carry_min)
                    best = max(best, pb)
                    seen["passes"] += 1
                out[c] = best
    assert (out >= 0).all()
    return out, seen


def sorted_profile_case(case):
    """The case's valid slots first, sorted by (query, target) as the
    prefilter's candidate stage hands them over, the invalid ones after;
    returns the case and its valid count."""
    case = list(case)
    order = np.lexsort((case[1], case[0], ~case[3]))
    for i in range(4):
        case[i] = np.ascontiguousarray(case[i][order])
    return case, int(case[3].sum())


PROFILE_SCHEDULE_CASES = {
    # slots sorted by (query, target), several queries a batch
    "sorted": dict(case=dict(seed=21, n_q=5, n_cand=1500, n_t=60),
                   sort=True, grid=3),
    # a query of 2,000 rows: windows of up to 16 passes beside short ones
    "long-query": dict(case=dict(seed=22, n_q=3, lq=2000, tmax=2100,
                                 n_cand=400, n_t=30), sort=True, grid=2),
    # slots in no order of query
    "unsorted": dict(case=dict(seed=24, n_q=6, lq=40, tmax=50,
                               n_cand=2000, n_t=80), sort=False, grid=2),
}


def schedule_case(name, counted):
    """A schedule case and its valid count (None without the count): a
    count inside the sorted valid slots, or half the unsorted slots."""
    spec = PROFILE_SCHEDULE_CASES[name]
    case = make_profile_case(**spec["case"])
    if spec["sort"]:
        case, k = sorted_profile_case(case)
        return case, (k - 7 if counted else None)
    return list(case), (len(case[0]) // 2 if counted else None)


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("name", sorted(PROFILE_SCHEDULE_CASES))
def test_profile_schedule_model_matches_plain(name, counted):
    """The kernel's schedule (warp batches, runs read from their rows,
    passes and scans) gives the plain version's scores and a Kadane
    loop's, with and without the valid count, on slots sorted by (query,
    target) (most batches of one query, some across a query change) and
    slots in no order of query, with windows of up to 16 passes."""
    case, n_valid = schedule_case(name, counted)
    grid = PROFILE_SCHEDULE_CASES[name]["grid"]
    got, seen = model_profile_kernel(case, grid, n_valid)
    nv = None if n_valid is None else torch.tensor(n_valid,
                                                   dtype=torch.int32)
    plain = tr.diag_rescore_profile_plain(*as_torch(case), nv).numpy()
    want = kadane_profile(case)
    if n_valid is not None:
        want[n_valid:] = 0
    assert np.array_equal(got, plain)
    assert np.array_equal(got, want)
    assert seen["mixed"] > 0
    if name != "unsorted":
        assert seen["one_query"] > 0
    if name == "long-query":
        assert seen["long_windows"] > 0


@pytest.mark.parametrize("name", ["sorted", "long-query"])
def test_profile_schedule_edges_plain_matches_jax(name):
    """The schedule's edge inputs (slots sorted by query, a query of 2,000
    rows) through the plain version and the JAX package's make_rescore."""
    import jax.numpy as jnp
    from mmseqs2_tpu.prefilter import device_stages as jds
    case, _ = sorted_profile_case(
        make_profile_case(**PROFILE_SCHEDULE_CASES[name]["case"]))
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len = case
    lq = prof.shape[1]
    rescore = jds.make_rescore(
        jnp.asarray(t_cat), jnp.asarray(t_off.astype(np.int32)),
        jnp.asarray(t_len), jnp.asarray(prof[:, :, :ALPHA].astype(np.int32)),
        jnp.asarray(q_len), lq_max=lq,
        ln_max=jds.bucket(max(lq, int(t_len.max())), 64), chunk=128)
    exact = np.asarray(rescore(*[jnp.asarray(a)
                                 for a in (cqid, cid, cdiag, cvalid)],
                               cap=False))
    got = tr.diag_rescore_profile_plain(*as_torch(case)).numpy()
    assert np.array_equal(got, exact)
    assert got.max() > 255


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def with_count(case, count):
    """The case and its valid count: None, a count below C with cvalid True
    past it, or 0; and the Kadane loop's answer under that count."""
    case = list(case)
    want = kadane(case)
    if count == "none":
        return case, None, want
    k = 0 if count == "zero" else len(case[0]) // 2
    case[3] = case[3].copy()
    case[3][k:] = True                        # stale slots past the count
    case[0] = np.where(case[3], case[0] % len(case[10]), 0).astype(np.int32)
    case[1] = np.where(case[3], case[1] % len(case[6]), 0).astype(np.int32)
    want = kadane(case)
    want[k:] = 0
    return case, k, want


def run_both(case, k, device):
    nv = None if k is None else torch.tensor(k, dtype=torch.int32)
    want = tr.diag_rescore_plain(*as_torch(case), nv)
    before = tr.diag_rescore.launches
    got = tr.diag_rescore(*as_torch(case, device),
                          None if nv is None else nv.to(device))
    torch.cuda.synchronize()
    assert tr.diag_rescore.launches == before + 1
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("count", ["none", "below", "zero"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_device, name, count):
    case, k, want = with_count(make_case(**CASES[name]), count)
    got, plain = run_both(case, k, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("slots,counted", [(1 << 16, True), (1 << 16, False),
                                          (1 << 18, True), (1 << 18, False)])
def test_kernel_with_many_more_slots_than_candidates(cuda_device, slots,
                                                     counted):
    """3,000 valid candidates in 2^16 or 2^18 slots (a warp takes batches
    of up to 32 slots when every warp still gets one); the slots past them
    hold stale candidates with cvalid True in every fourth slot, which the
    count overrides and which, without it, are candidates too."""
    case = list(make_case(seed=11, n_cand=3000, n_t=200))
    pad = slots - 3000
    rng = np.random.default_rng(12)
    case[0] = np.concatenate([case[0], rng.integers(0, 6, pad)]).astype(
        np.int32)
    case[1] = np.concatenate([case[1], rng.integers(0, 200, pad)]).astype(
        np.int32)
    case[2] = np.concatenate([case[2], np.zeros(pad, np.int32)])
    case[3] = np.concatenate([case[3], np.arange(pad) % 4 == 0])
    got, plain = run_both(case, 3000 if counted else None, cuda_device)
    assert torch.equal(got, plain)
    assert got[:3000].any()
    if counted:
        assert (got[3000:] == 0).all()
    else:
        assert np.array_equal(got.numpy(), kadane(case))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", range(16))
def test_kernel_with_misaligned_target_offsets(cuda_device, shift):
    """The target store shifted by `shift` bytes (every t_off moves): the
    words the kernel loads start at every alignment, and the last target's
    window ends at the end of the store."""
    case = list(make_case(seed=13, n_cand=500))
    case[4] = np.concatenate([np.full(shift, 3, np.int8), case[4]])
    case[5] = case[5] + shift
    got, plain = run_both(case, None, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), kadane(case))


def boundary_case():
    """Windows of 1, K - 1, K, K + 1, G K - 1, G K, G K + 1 and several
    G K cells (diagonal 0 of query 0 against targets of those lengths)."""
    lens = [n for n in BOUNDARY_LENGTHS if n > 0]
    case = list(make_case(seed=14, n_q=2, lq=max(lens), tmax=2,
                          n_cand=16, planted=False))
    rng = np.random.default_rng(15)
    seqs = [rng.integers(0, ALPHA - 1, size=n).astype(np.int8)
            for n in lens]
    case[0] = np.zeros(len(lens), np.int32)
    case[1] = np.arange(len(lens), dtype=np.int32)
    case[2] = np.zeros(len(lens), np.int32)
    case[3] = np.ones(len(lens), bool)
    case[4] = np.concatenate(seqs)
    case[6] = np.array(lens, np.int32)
    case[5] = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    case[10] = np.array([max(lens), 1], np.int32)
    q = case[7]
    q[0] = rng.integers(0, ALPHA - 1, size=q.shape[1])
    q[0, :lens[-1] // 2] = seqs[-1][:lens[-1] // 2]     # a planted half
    return case


@pytest.mark.cuda
@pytest.mark.parametrize("count", ["none", "below"])
def test_kernel_windows_at_the_run_boundaries(cuda_device, count):
    """Windows at the edges of a lane's run and of a group's pass; with a
    count below C, the longer half lies past it."""
    case, k, want = with_count(boundary_case(), count)
    got, plain = run_both(case, k, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)
    assert want.max() > 0


@pytest.mark.cuda
def test_flush_on_the_card_equals_the_cpu(cuda_device):
    """One host-expanded flush through device_match_pre (the torch stages
    and the kernel) on the card, against the same flush on the CPU (the
    same stages on CPU tensors, the plain rescore): equal outputs."""
    from mmseqs2_tpu_torch.prefilter.device import device_match_pre
    n_q, n_t, tb, h = 6, 40, 6, 6000
    _, _, _, _, t_cat, t_off, t_len, q_pad, corr, m, q_len = make_case(
        seed=9, n_t=n_t, n_q=n_q)
    rng = np.random.default_rng(10)
    qid = np.sort(rng.integers(0, n_q, size=h))
    qtid = ((qid << tb) | rng.integers(0, n_t, size=h)).astype(np.int32)
    qtid[-50:] = I32_MAX
    diag = (rng.integers(-3, 4, size=h) + 256 * rng.integers(0, 2, size=h)
            ).astype(np.int16)
    identity = np.array([-1, 3, -1, 0, 7, -1], np.int32)
    arrays = (qtid, diag, t_cat, t_off, t_len, q_pad, corr, m, q_len,
              identity)
    kw = dict(n_q=n_q, max_hits=5, min_diag_thr=15, out_sz=n_q * 5, tb=tb)
    want = device_match_pre(*as_torch(arrays), **kw)
    got = device_match_pre(*as_torch(arrays, cuda_device), **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[1][1]) > n_q          # hits were kept


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_flush_record_counts_the_rescore(device):
    """device_match_pre with a record: the same outputs, the rescore run
    once (a kernel launch on the card, the plain version on the CPU), the
    slots, and a window histogram over exactly the flush's valid
    candidates, equal to numpy's count of their window lengths."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from mmseqs2_tpu_torch.prefilter import device as pdev
    n_q, n_t, tb, h = 6, 40, 6, 6000
    _, _, _, _, t_cat, t_off, t_len, q_pad, corr, m, q_len = make_case(
        seed=9, n_t=n_t, n_q=n_q)
    rng = np.random.default_rng(16)
    qid = np.sort(rng.integers(0, n_q, size=h))
    qtid = ((qid << tb) | rng.integers(0, n_t, size=h)).astype(np.int32)
    diag = rng.integers(-3, 4, size=h).astype(np.int16)
    arrays = as_torch((qtid, diag, t_cat, t_off, t_len, q_pad, corr, m,
                       q_len, np.full(n_q, -1, np.int32)), device)
    kw = dict(n_q=n_q, max_hits=5, min_diag_thr=15, out_sz=n_q * 5, tb=tb)
    want = pdev.device_match_pre(*arrays, **kw)
    record = {}
    before = tr.diag_rescore.launches
    got = pdev.device_match_pre(*arrays, **kw, record=record)
    assert tr.diag_rescore.launches == before + (device == "cuda")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert record["slots"] == h
    hist = record["windows"].cpu().numpy()
    n_cand = int(got[1][0])
    assert hist.sum() == n_cand > 0
    cqid, cid, cdiag, cvalid, n, _ = pdev.stage_candidates_pre(
        *as_torch((qtid, diag)), c_cap=h, tb=tb)
    cells = tr.window_cells(cqid, cid, cdiag, cvalid,
                            *as_torch((t_len, q_len)), n).numpy()
    assert np.array_equal(hist, np.bincount(
        np.minimum(cells[cells >= 0] // pdev.WINDOW_BIN,
                   pdev.WINDOW_BINS - 1), minlength=pdev.WINDOW_BINS))


# -- the profile form on the card ----------------------------------------------

def run_both_profile(case, k, device):
    nv = None if k is None else torch.tensor(k, dtype=torch.int32)
    want = tr.diag_rescore_profile_plain(*as_torch(case), nv)
    before = tr.diag_rescore_profile.launches
    got = tr.diag_rescore_profile(*as_torch(case, device),
                                  None if nv is None else nv.to(device))
    torch.cuda.synchronize()
    assert tr.diag_rescore_profile.launches == before + 1
    return got.cpu(), want


def with_count_profile(case, count):
    case = list(case)
    if count == "none":
        return case, None, kadane_profile(case)
    k = 0 if count == "zero" else len(case[0]) // 2
    case[3] = case[3].copy()
    case[3][k:] = True                        # stale slots past the count
    case[0] = np.where(case[3], case[0] % len(case[8]), 0).astype(np.int32)
    case[1] = np.where(case[3], case[1] % len(case[6]), 0).astype(np.int32)
    want = kadane_profile(case)
    want[k:] = 0
    return case, k, want


@pytest.mark.cuda
@pytest.mark.parametrize("count", ["none", "below", "zero"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_profile_kernel_matches_plain(cuda_device, name, count):
    case, k, want = with_count_profile(make_profile_case(**CASES[name]),
                                       count)
    got, plain = run_both_profile(case, k, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 3, 7, 15])
@pytest.mark.parametrize("counted", [False, True])
def test_profile_kernel_with_many_slots_and_shifted_store(cuda_device, shift,
                                                          counted):
    """3,000 valid candidates in 2^16 slots, stale candidates past them,
    and the target store shifted by `shift` bytes (windows at every
    alignment; the last target's window ends at the store's end)."""
    case = list(make_profile_case(seed=11, n_cand=3000, n_t=200))
    case[4] = np.concatenate([np.full(shift, 3, np.int8), case[4]])
    case[5] = case[5] + shift
    pad = (1 << 16) - 3000
    rng = np.random.default_rng(12)
    case[0] = np.concatenate([case[0], rng.integers(0, 6, pad)]).astype(
        np.int32)
    case[1] = np.concatenate([case[1], rng.integers(0, 200, pad)]).astype(
        np.int32)
    case[2] = np.concatenate([case[2], np.zeros(pad, np.int32)])
    case[3] = np.concatenate([case[3], np.arange(pad) % 4 == 0])
    got, plain = run_both_profile(case, 3000 if counted else None,
                                  cuda_device)
    assert torch.equal(got, plain)
    assert got[:3000].any()
    if counted:
        assert (got[3000:] == 0).all()
    else:
        assert np.array_equal(got.numpy(), kadane_profile(case))


@pytest.mark.cuda
def test_profile_kernel_windows_at_the_run_boundaries(cuda_device):
    """boundary_case's windows (the edges of a lane's run and of a group's
    pass) with query 0's profile rows built from its letters."""
    case = boundary_case()
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, m, q_len = \
        case
    prof = np.zeros(q_pad.shape + (tr.PROFILE_WIDTH,), np.int8)
    for b in range(len(q_len)):
        prof[b] = tr.profile_rows(m[q_pad[b].astype(np.int64)]
                                  + corr[b].astype(np.int32)[:, None])
    pcase = (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len)
    got, plain = run_both_profile(pcase, None, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), kadane(case))
    assert got.max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("name", sorted(PROFILE_SCHEDULE_CASES))
def test_profile_kernel_schedule_cases(cuda_device, name, counted):
    """The schedule model's cases on the card: slots sorted by (query,
    target) and not, a query of 2,000 rows, windows of no cell among the
    valid slots."""
    case, k = schedule_case(name, counted)
    want = kadane_profile(case)
    if k is not None:
        want[k:] = 0
    got, plain = run_both_profile(case, k, cuda_device)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("order", ["any", "by-query"])
def test_profile_kernel_with_more_candidates_than_warps(cuda_device, order,
                                                        counted):
    """20,000 candidates, more than the card's warps (4,224 on an H100), so
    that a warp takes more than one batch of slots: in no order of query
    (batches of several queries), and sorted by (query, target) (batches
    of one query, and some across a query change)."""
    case = make_profile_case(seed=41, n_q=12, lq=60, tmax=80, n_t=300,
                             n_cand=20_000)
    k = None
    if order == "by-query":
        case, k = sorted_profile_case(case)
        k = k - 5 if counted else None
    elif counted:
        k = 15_000
    got, plain = run_both_profile(list(case), k, cuda_device)
    assert torch.equal(got, plain)
    assert got.max() > 0


@pytest.mark.cuda
def test_profile_flush_on_the_card_equals_the_cpu(cuda_device):
    """A profile-query flush through device_match_pre on the card against
    the same flush on the CPU."""
    from mmseqs2_tpu_torch.prefilter.device import device_match_pre
    n_q, n_t, tb, h = 6, 40, 6, 6000
    _, _, _, _, t_cat, t_off, t_len, prof, q_len = make_profile_case(
        seed=9, n_t=n_t, n_q=n_q)
    rng = np.random.default_rng(10)
    qid = np.sort(rng.integers(0, n_q, size=h))
    qtid = ((qid << tb) | rng.integers(0, n_t, size=h)).astype(np.int32)
    qtid[-50:] = I32_MAX
    diag = (rng.integers(-3, 4, size=h) + 256 * rng.integers(0, 2, size=h)
            ).astype(np.int16)
    identity = np.array([-1, 3, -1, 0, 7, -1], np.int32)
    arrays = (qtid, diag, t_cat, t_off, t_len)
    kw = dict(n_q=n_q, max_hits=5, min_diag_thr=15, out_sz=n_q * 5, tb=tb,
              q_pad=None, corr=None, submat=None)

    def run(dev):
        t = as_torch(arrays, dev)
        p, ql, ident = as_torch((prof, q_len, identity), dev)
        return device_match_pre(*t, q_len=ql, identity=ident, prof=p, **kw)
    want = run("cpu")
    before = tr.diag_rescore_profile.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert tr.diag_rescore_profile.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[1][1]) > n_q          # hits were kept
