"""The port's ungapped diagonal rescore (mmseqs2_tpu_torch.ops.rescore)
against the JAX package's rescorers (device_stages.make_rescore and
make_rescore_from_letters, on the CPU) and against a plain Kadane loop in
numpy. Every output is an integer: tolerance 0.

The card tests (the kernel against its plain version, and a whole flush of
the prefilter's device stages against the same flush on the CPU) need a
CUDA card and skip without one; on the CPU the wrapper runs its plain
version. JAX is imported inside the tests that compare with it, so the card
tests also run where only PyTorch is installed:
    python -m pytest tests/test_torch_rescore.py -m cuda"""

import numpy as np
import pytest
import torch

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


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_device, name):
    case = make_case(**CASES[name])
    want = tr.diag_rescore_plain(*as_torch(case))
    before = tr.diag_rescore.launches
    got = tr.diag_rescore(*as_torch(case, cuda_device))
    torch.cuda.synchronize()
    assert tr.diag_rescore.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.cpu().numpy(), kadane(case))


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
