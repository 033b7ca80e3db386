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


def make_case(seed, lq, lt, b, kind="random", pad_rows=0):
    """One (32, lq) profile and (b, lt) targets. "pallas" is the input of
    tests/test_pallas.py; "random" plants mutated fragments of the query in
    half of the lanes; "identical" makes every lane hold the query itself at
    several offsets (long runs that reach a small cap early, so the
    first-column rule decides); "negative" scores every cell below 0."""
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
        prof[:, lq - pad_rows:] = -(1 << 20)
    return np.ascontiguousarray(prof), targets


def port(fn, prof, targets, cap, device="cpu"):
    out = fn(torch.from_numpy(prof).to(device),
             torch.from_numpy(np.ascontiguousarray(
                 targets.T.astype(np.int8))).to(device), cap)
    if isinstance(out, tuple):
        return [o.cpu().numpy() for o in out]
    return out.cpu().numpy()


# (seed, lq, lt, b, kind, cap, pad_rows); the Pallas comparison runs in
# interpret mode, so the shapes stay as small as tests/test_pallas.py's
CASES = {
    "test_pallas input, cap 250": (3, 64, 96, 8, "pallas", 250, 0),
    "cap 255 - 4": (11, 64, 96, 8, "random", 251, 0),
    "cap 255 - 60": (12, 64, 80, 8, "random", 195, 0),
    "small cap, many cells reach it": (13, 64, 96, 16, "identical", 40, 0),
    "all-negative": (14, 64, 96, 8, "negative", 250, 0),
    "lq 50, no multiple of 8": (15, 50, 72, 8, "random", 250, 0),
    "pad rows": (16, 72, 56, 8, "random", 250, 9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gapless_plain_matches_pallas_and_dp(name):
    """Tracking form: sw_pallas(gapless=True) in interpret mode and both
    packages' dp.gapless_scan(with_endpos=True)."""
    from mmseqs2_tpu.ops import dp as jdp
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas
    seed, lq, lt, b, kind, cap, pad_rows = CASES[name]
    prof, targets = make_case(seed, lq, lt, b, kind, pad_rows)
    got = port(tg.gapless, prof, targets, cap)
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
    seed, lq, lt, b, kind, cap, pad_rows = CASES[name]
    prof, targets = make_case(seed, lq, lt, b, kind, pad_rows)
    got = port(tg.gapless_score, prof, targets, cap)
    want = np.asarray(gapless_pallas_score(
        prof, targets.T.astype(np.int8), cap=cap, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port(tg.gapless, prof, targets,
                                            cap)[0])


def test_gapless_cpu_uses_plain_versions_and_checks_inputs():
    prof, targets = make_case(1, 32, 40, 6)
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


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lt,b,kind,cap,pad_rows", [
    (32, 40, 8, "random", 250, 0), (50, 72, 9, "random", 251, 3),
    (512, 300, 600, "random", 195, 40), (256, 512, 300, "identical", 40, 0),
    (128, 256, 64, "negative", 250, 0), (2500, 200, 40, "random", 250, 100),
    (2048, 160, 33, "identical", 5000, 0)])
def test_gapless_kernels_match_plain(cuda_device, lq, lt, b, kind, cap,
                                     pad_rows):
    """Both forms of the kernel against their plain versions (run on the
    CPU) and against each other."""
    prof, targets = make_case(lq, lq, lt, b, kind, pad_rows)
    want = port(tg.gapless, prof, targets, cap)
    want_s = port(tg.gapless_score, prof, targets, cap)
    before = tg.gapless.launches, tg.gapless_score.launches
    got = port(tg.gapless, prof, targets, cap, cuda_device)
    got_s = port(tg.gapless_score, prof, targets, cap, cuda_device)
    assert (tg.gapless.launches, tg.gapless_score.launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_s, got[0])
