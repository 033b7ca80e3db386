"""The port's SW scan (mmseqs2_tpu_torch.ops.sw / ops.dp) against the JAX
package: the Pallas kernel in interpret mode, the JAX column scans and the
naive reference. Every output is an integer, so agreement is exact.

Kernel tests need a CUDA card and skip without one; on the CPU the wrapper
runs its plain version. JAX is imported inside the tests that compare with
it, so that the kernel tests also run where only PyTorch is installed:
    python -m pytest tests/test_torch_sw.py -m cuda"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import device as tdevice
from mmseqs2_tpu_torch.ops import dp as tdp
from mmseqs2_tpu_torch.ops import sw as tsw

REPO = pathlib.Path(__file__).resolve().parents[1]
NEG_INF = -(1 << 28)


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


def make_case(seed, nq, lq, lt, b, offsets=False, pad_rows=0):
    """prof_flat (nq*32, lq), targets (b, lt), qsel, qoff; homologs planted
    in half the lanes. pad_rows query rows at the end score -(1 << 20)."""
    rng = np.random.default_rng(seed)
    m = _matrix(rng)
    profs, seqs = [], []
    for _ in range(nq):
        q = rng.integers(0, 20, size=lq)
        prof = m[q, :].T.astype(np.int32)
        if pad_rows:
            prof[:, lq - pad_rows:] = -(1 << 20)
        profs.append(prof)
        seqs.append(q)
    prof_flat = np.ascontiguousarray(np.concatenate(profs, axis=0))
    qsel = rng.integers(0, nq, size=b).astype(np.int32)
    targets = rng.integers(0, 20, size=(b, lt)).astype(np.int32)
    for k in range(0, b, 2):
        q = seqs[qsel[k]]
        n = int(rng.integers(8, min(lq, lt) - 4))
        qs = int(rng.integers(0, lq - n))
        ts = int(rng.integers(0, lt - n))
        frag = q[qs:qs + n].copy()
        mut = rng.random(n) < 0.2
        frag[mut] = rng.integers(0, 20, size=int(mut.sum()))
        targets[k, ts:ts + n] = frag
    qoff = (rng.integers(0, lq, size=b).astype(np.int32) if offsets
            else np.zeros(b, np.int32))
    return prof_flat, targets, qsel, qoff


def port_sw_multi(prof_flat, targets, qsel, qoff, go, ge):
    out = tsw.sw_multi(torch.from_numpy(prof_flat),
                       torch.from_numpy(np.ascontiguousarray(
                           targets.T.astype(np.int8))),
                       torch.from_numpy(qsel), torch.from_numpy(qoff),
                       go=go, ge=ge)
    return [o.numpy() for o in out]


def _jdp():
    from mmseqs2_tpu.ops import dp
    return dp


def masked_profiles(prof_flat, qsel, qoff):
    """One profile per lane whose rows below qoff score NEG_INF (the offset
    semantics spelled out), for the dp.sw_scan oracles."""
    nq = prof_flat.shape[0] // 32
    profs = prof_flat.reshape(nq, 32, -1)[qsel].copy()
    for k, o in enumerate(qoff):
        profs[k, :, :o] = NEG_INF
    return profs


def jax_sw_scan_masked(prof_flat, targets, qsel, qoff, go, ge):
    return [np.asarray(x) for x in _jdp().sw_scan(
        masked_profiles(prof_flat, qsel, qoff),
        np.arange(len(qsel), dtype=np.int32), targets, go, ge)]


# (nq, lq, lt, b, offsets, go, ge): the Pallas comparison runs in
# interpret mode, so the shapes stay as small as tests/test_pallas.py's
PALLAS_CASES = [
    (1, 32, 40, 8, False, 11, 1),
    (3, 64, 48, 12, True, 11, 1),
    (4, 72, 40, 16, True, 13, 2),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_sw_multi_plain_matches_pallas(case):
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas_multi
    nq, lq, lt, b, offsets, go, ge = case
    prof_flat, targets, qsel, qoff = make_case(lq + nq, nq, lq, lt, b,
                                               offsets)
    got = port_sw_multi(prof_flat, targets, qsel, qoff, go, ge)
    want = [np.asarray(x) for x in sw_pallas_multi(
        prof_flat, targets.T.astype(np.int8), qsel, qoff=qoff, go=go, ge=ge,
        interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].max() > 0


@pytest.mark.parametrize("go,ge", [(11, 1), (13, 2), (3, 1), (2, 2)])
@pytest.mark.parametrize("nq,lq,offsets", [(1, 32, False), (2, 64, True),
                                           (4, 72, True)])
def test_sw_multi_plain_matches_dp(nq, lq, offsets, go, ge):
    prof_flat, targets, qsel, qoff = make_case(7 * lq + go, nq, lq, 56, 24,
                                               offsets, pad_rows=5)
    got = port_sw_multi(prof_flat, targets, qsel, qoff, go, ge)
    want = jax_sw_scan_masked(prof_flat, targets, qsel, qoff, go, ge)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the port's own oracle agrees too
    mine = tdp.sw_scan(masked_profiles(prof_flat, qsel, qoff),
                       np.arange(len(qsel)), targets, go, ge)
    for g, w in zip(mine, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_sw_multi_sentinel_and_unpacked_bound():
    """All-negative lanes give (0, lq-1, -1); a score bound past the TPU
    kernel's packed-tracking limit (as in tests/test_pallas.py) changes
    nothing for the port."""
    from mmseqs2_tpu.ops.pallas_sw import _pk_for, sw_pallas_multi
    rng = np.random.default_rng(5)
    lq, lt, b = 72, 96, 8
    targets = rng.integers(0, 20, size=(b, lt)).astype(np.int32)
    neg = np.full((32, lq), -9, np.int32)
    big = _matrix(rng)[rng.integers(0, 20, size=lq), :].T.astype(np.int32)
    big[0, 0] = 255
    assert 255 * lq >= (1 << 24) // _pk_for(lt) - 1
    prof_flat = np.concatenate([neg, big])
    qsel = np.array([0, 1] * (b // 2), np.int32)
    qoff = np.zeros(b, np.int32)
    got = port_sw_multi(prof_flat, targets, qsel, qoff, 11, 1)
    assert np.array_equal(got[0][::2], np.zeros(b // 2))
    assert np.array_equal(got[1][::2], np.full(b // 2, lq - 1))
    assert np.array_equal(got[2][::2], np.full(b // 2, -1))
    want = [np.asarray(x) for x in sw_pallas_multi(
        prof_flat, targets.T.astype(np.int8), qsel, qoff=qoff,
        interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want = jax_sw_scan_masked(prof_flat, targets, qsel, qoff, 11, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the single-profile entry points -------------------------------------------

def _single_args(prof, targets, qoff=None, device="cpu"):
    args = [torch.from_numpy(prof),
            torch.from_numpy(np.ascontiguousarray(targets.T.astype(np.int8)))]
    if qoff is not None:
        args.append(torch.from_numpy(qoff))
    return [a.to(device) for a in args]


# (lq, lt, b, go, ge)
SINGLE_CASES = [(32, 40, 8, 11, 1), (72, 40, 16, 13, 2)]


@pytest.mark.parametrize("case", SINGLE_CASES)
def test_sw_single_plain_matches_pallas(case):
    """sw_single against the gapped sw_pallas in interpret mode: the SW
    semantics of the gapped exhaustive prefilter on a device (E reads the
    previous column's H after the lazy-F correction)."""
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas
    lq, lt, b, go, ge = case
    prof, targets, _, _ = make_case(lq + lt, 1, lq, lt, b)
    got = tsw.sw_single(*_single_args(prof, targets), go=go, ge=ge)
    want = sw_pallas(prof, targets.T.astype(np.int8), go=go, ge=ge,
                     interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) > 0


@pytest.mark.parametrize("case", SINGLE_CASES)
def test_sw_offset_plain_matches_pallas(case):
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas_offset
    lq, lt, b, go, ge = case
    prof, targets, _, qoff = make_case(lq + lt + 1, 1, lq, lt, b,
                                       offsets=True)
    got = tsw.sw_offset(*_single_args(prof, targets, qoff), go=go, ge=ge)
    want = sw_pallas_offset(prof, targets.T.astype(np.int8), qoff, go=go,
                            ge=ge, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the rows below qoff are out of reach
    assert bool((got[1] >= torch.from_numpy(qoff))[got[0] > 0].all())


@pytest.mark.parametrize("case", SINGLE_CASES)
def test_sw_score_plain_matches_pallas(case):
    from mmseqs2_tpu.ops.pallas_sw import sw_pallas_score
    lq, lt, b, go, ge = case
    prof, targets, _, _ = make_case(lq + lt + 2, 1, lq, lt, b)
    args = _single_args(prof, targets)
    got = tsw.sw_score(*args, go=go, ge=ge)
    want = sw_pallas_score(prof, targets.T.astype(np.int8), go=go, ge=ge,
                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tsw.sw_single(*args, go=go, ge=ge)[0])


def test_single_entry_points_count_their_own_launches_and_check_inputs():
    prof, targets, _, qoff = make_case(2, 1, 32, 40, 6, offsets=True)
    before = [w.launches for w in (tsw.sw_single, tsw.sw_offset,
                                   tsw.sw_score, tsw.sw_multi)]
    tsw.sw_single(*_single_args(prof, targets))
    tsw.sw_offset(*_single_args(prof, targets, qoff))
    tsw.sw_score(*_single_args(prof, targets))
    assert before == [w.launches for w in (tsw.sw_single, tsw.sw_offset,
                                           tsw.sw_score, tsw.sw_multi)]
    two = torch.zeros((64, 8), dtype=torch.int32)       # two profiles
    t = torch.zeros((4, 2), dtype=torch.int8)
    for fn in (tsw.sw_single, tsw.sw_score):
        with pytest.raises(ValueError):
            fn(two, t)
    with pytest.raises(ValueError):
        tsw.sw_offset(two[:32], t, torch.zeros(3, dtype=torch.int32))


# -- the port's dp oracle on the inputs of tests/test_dp.py ------------------

def _dp_random_case(rng, nq=3, b=8, lq=24, lt=40, alpha=21):
    profs = []
    for _ in range(nq):
        m = rng.integers(-4, 3, size=(alpha, alpha))
        m = ((m + m.T) // 2).astype(np.int32)
        np.fill_diagonal(m, rng.integers(4, 12, size=alpha))
        seq = rng.integers(0, alpha, size=lq)
        profs.append(m[seq, :].T.astype(np.int32))
    qidx = rng.integers(0, nq, size=b).astype(np.int32)
    targets = rng.integers(0, alpha, size=(b, lt)).astype(np.int32)
    return np.stack(profs), qidx, targets


def test_dp_gapless_matches_jax():
    jdp = _jdp()
    rng = np.random.default_rng(42)
    profiles, qidx, targets = _dp_random_case(rng)
    caps = np.full(len(qidx), 250, dtype=np.int32)
    got = tdp.gapless_scan(profiles, qidx, targets, caps, with_endpos=True)
    want = jdp.gapless_scan(profiles, qidx, targets, caps, with_endpos=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in range(len(qidx)):
        assert int(got[0][k]) == jdp.gapless_ref(profiles[qidx[k]],
                                                 targets[k], caps[k])
    # saturation at the cap
    m = np.full((21, 21), -4, dtype=np.int32)
    np.fill_diagonal(m, 11)
    seq = rng.integers(0, 21, size=64)
    prof = m[seq, :].T.astype(np.int32)[None]
    assert int(tdp.gapless_scan(prof, np.zeros(1, np.int32), seq[None],
                                np.array([250]))[0]) == 250


def test_dp_sw_scan_matches_jax_and_naive():
    jdp = _jdp()
    rng = np.random.default_rng(42)
    profiles, qidx, targets = _dp_random_case(rng, b=16, lq=33, lt=47)
    got = [g.numpy() for g in tdp.sw_scan(profiles, qidx, targets, 11, 1)]
    want = [np.asarray(w) for w in jdp.sw_scan(profiles, qidx, targets,
                                               11, 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k in range(len(qidx)):
        assert jdp.sw_ref(profiles[qidx[k]], targets[k], 11, 1) == (
            got[0][k], got[1][k], got[2][k])
    # all-negative: nothing aligns, sentinels kept
    prof = np.full((4, 8), -3, dtype=np.int32)[None]
    s, qe, te = tdp.sw_scan(prof, np.zeros(1, np.int32),
                            np.ones((1, 10), np.int32), 11, 1)
    assert (int(s[0]), int(qe[0]), int(te[0])) == (0, 7, -1)


# -- wrapper, device picker, import isolation ---------------------------------

def test_sw_multi_cpu_uses_plain_version_and_checks_inputs():
    prof_flat, targets, qsel, qoff = make_case(1, 2, 32, 40, 6)
    before = tsw.sw_multi.launches
    port_sw_multi(prof_flat, targets, qsel, qoff, 11, 1)
    assert tsw.sw_multi.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError):
        tsw.sw_multi(torch.zeros((31, 8), dtype=torch.int32),
                     torch.zeros((4, 2), dtype=torch.int8),
                     torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsw.sw_multi(torch.zeros((32, 8), dtype=torch.int32),
                     torch.zeros((4, 2), dtype=torch.int8),
                     torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsw.sw_multi(torch.zeros((32, 8), dtype=torch.int32),
                     torch.zeros((4, 2), dtype=torch.int8),
                     torch.zeros(2, dtype=torch.int32), go=1, ge=2)


def test_device_picker(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(tdevice.ENV, raising=False)
    with pytest.raises(RuntimeError, match="MMSEQS2_TPU_TORCH_DEVICE=cpu"):
        tdevice.get_device()
    monkeypatch.setenv(tdevice.ENV, "cpu")
    assert tdevice.get_device() == torch.device("cpu")
    monkeypatch.setenv(tdevice.ENV, "tpu")
    with pytest.raises(ValueError):
        tdevice.get_device()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "mmseqs2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mmseqs2_tpu"), (f, mod)


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def cut_to_lengths(prof_flat, targets, seed, shortest):
    """Real lengths for make_case's arrays: each profile's rows past a
    length in [shortest * lq, lq] and its pad letter's row score -(1 << 20),
    and each target is cut to a length in [lt / 2, lt] (pad letter 31
    past it). Returns (q_lens, t_lens) as int32 arrays."""
    rng = np.random.default_rng(seed)
    nq, lq = prof_flat.shape[0] // 32, prof_flat.shape[1]
    q_lens = rng.integers(max(int(shortest * lq), 1), lq + 1,
                          size=nq).astype(np.int32)
    for q, n in enumerate(q_lens):
        prof_flat[q * 32:(q + 1) * 32, n:] = -(1 << 20)
        prof_flat[q * 32 + 31] = -(1 << 20)
    b, lt = targets.shape
    t_lens = rng.integers(lt // 2, lt + 1, size=b).astype(np.int32)
    for k, n in enumerate(t_lens):
        targets[k, n:] = 31
    return q_lens, t_lens


@pytest.mark.cuda
@pytest.mark.parametrize("nq,lq,lt,b,offsets,shortest", [
    (1, 32, 40, 8, False, 0.75), (4, 72, 40, 16, True, 0.75),
    (16, 512, 300, 600, True, 0.75), (1, 2500, 200, 40, True, 0.75),
    (16, 512, 300, 600, False, 0.125)])        # mixed query lengths
@pytest.mark.parametrize("form", ["picked", "int32"])
@pytest.mark.parametrize("lengths", [True, False])
def test_sw_multi_kernel_matches_plain(cuda_device, nq, lq, lt, b, offsets,
                                       shortest, form, lengths):
    """The kernel against both oracles: its plain version (E from the
    post-F H, as the TPU kernel) and the port's dp.sw_scan (E from the
    pre-F H), the latter on the card; in the form pick_form chooses and in
    the int32 form (one entry raised so that it is chosen), with the real
    lengths (q_lens, t_lens, prof_max and the longest window) and
    without."""
    prof_flat, targets, qsel, qoff = make_case(lq, nq, lq, lt, b, offsets)
    q_lens, t_lens = cut_to_lengths(prof_flat, targets, lq + b, shortest)
    if form == "int32":
        prof_flat[0, 0] = 40_000
    args = [torch.from_numpy(prof_flat),
            torch.from_numpy(np.ascontiguousarray(targets.T.astype(np.int8))),
            torch.from_numpy(qsel), torch.from_numpy(qoff)]
    ends = q_lens[qsel] if lengths else np.full(b, lq)
    longest = int(np.maximum(ends - qoff, 0).max())
    kw = dict(go=11, ge=1)
    if lengths:
        kw.update(q_lens=torch.from_numpy(q_lens),
                  t_lens=torch.from_numpy(t_lens),
                  prof_max=int(prof_flat.max()), max_window=longest)
    want = tsw.sw_multi_plain(*args, **kw)
    expect = tsw.pick_form(longest, int(prof_flat.max()), 11, 1)
    assert (expect == "int32") == (form == "int32")
    before = (tsw.sw_multi.launches, dict(tsw.sw_multi.form_launches))
    got = tsw.sw_multi(*[a.to(cuda_device) for a in args],
                       **{k: v.to(cuda_device) if torch.is_tensor(v) else v
                          for k, v in kw.items()})
    torch.cuda.synchronize()
    assert tsw.sw_multi.launches == before[0] + 1
    assert tsw.sw_multi.form_launches[expect] == before[1][expect] + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[0].max()) > 0
    oracle = tdp.sw_scan(
        torch.from_numpy(masked_profiles(prof_flat, qsel, qoff)).to(
            cuda_device), np.arange(b), targets, 11, 1)
    for g, w in zip(got, oracle):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lt,b", [(32, 40, 8), (72, 40, 17),
                                     (512, 300, 600), (2500, 200, 40)])
def test_single_entry_points_kernel_matches_plain(cuda_device, lq, lt, b):
    """sw_single, sw_offset and sw_score on the card against their plain
    versions on the CPU; each counts its own launch and not sw_multi's."""
    prof, targets, _, qoff = make_case(lq + 3, 1, lq, lt, b, offsets=True)
    cpu = _single_args(prof, targets, qoff)
    dev = _single_args(prof, targets, qoff, cuda_device)
    before = [w.launches for w in (tsw.sw_single, tsw.sw_offset,
                                   tsw.sw_score, tsw.sw_multi)]
    got = tsw.sw_single(*dev[:2], go=11, ge=1)
    got_off = tsw.sw_offset(*dev, go=11, ge=1)
    got_s = tsw.sw_score(*dev[:2], go=11, ge=1)
    torch.cuda.synchronize()
    after = [w.launches for w in (tsw.sw_single, tsw.sw_offset,
                                  tsw.sw_score, tsw.sw_multi)]
    assert after == [before[0] + 1, before[1] + 1, before[2] + 1, before[3]]
    for g, w in zip(got, tsw.sw_single_plain(*cpu[:2], go=11, ge=1)):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got_off, tsw.sw_offset_plain(*cpu, go=11, ge=1)):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_s.cpu(), tsw.sw_score_plain(*cpu[:2], go=11, ge=1))
    assert torch.equal(got_s, got[0])
