"""The port's forward-backward alignment (B5, `fwbw`) with the CPU requested:
the plain version against the JAX package's `_fwbw_p` and `_mac` and its
f64 oracle, the command against the reference golden (tests/golden/fwbw)
and against the JAX command. The kernel against the plain version needs
the card (the `cuda` case). JAX is imported inside the tests that compare
with it.

Tolerances. P: relative 1e-4 with an absolute 1e-7 against XLA (the
partition function's sums run in another order in f32: the in-row scan of
ze and the logsumexp, through a log of a few hundred), and the JAX test's
own rtol 2e-3, atol 1e-6 against the oracle. The MAC on the same P is
exact: states, score and first maximum. The command's integer fields
equal the golden's and its MAC score is within 3 of it, as
tests/test_fwbw.py holds the JAX package (the reference's polynomial exp
and blocks of 16)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import fwbw_cmd
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.ops import fwbw as F

REPO = pathlib.Path(__file__).resolve().parents[1]
G = REPO / "tests" / "golden" / "fwbw"
TOY = REPO / "tests" / "golden" / "toy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(ENV, "cpu")


def random_pairs(seed, shapes, alpha=21):
    """(queries, targets, matrix) for pairs of the given (tlen, qlen), each
    its own query and target, scores drawn as the JAX test draws them."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(-4, 8, size=(alpha, alpha)).astype(np.float32)
    qs = [rng.integers(0, alpha, size=q) for _, q in shapes]
    ts = [rng.integers(0, alpha, size=t) for t, _ in shapes]
    return qs, ts, mat


def jax_p(S):
    """The JAX package's P of one (tlen, qlen) score matrix, padded to its
    buckets as fwbw_align pads it."""
    import jax.numpy as jnp
    from mmseqs2_tpu.ops.fwbw import FLT_MIN_EXP, _bucket, _fwbw_p
    t, q = S.shape
    Sp = np.full((_bucket(t), _bucket(q)), FLT_MIN_EXP, np.float32)
    Sp[:t, :q] = S
    P = np.asarray(_fwbw_p(jnp.asarray(Sp), t, q, go=-10.0, ge=-2.0,
                           temp=1.0))
    return P[:t, :q]


def cells(x, pairs, b):
    t, q = int(pairs.t_len[b]), int(pairs.q_len[b])
    lo = int(pairs.cell_off[b])
    return x[lo:lo + t * q].reshape(t, q)


SHAPES = [(13, 17), (40, 33), (64, 64), (70, 9), (1, 5)]


def test_p_matches_the_jax_package_and_the_oracle():
    from mmseqs2_tpu.ops.fwbw import fwbw_oracle
    qs, ts, mat = random_pairs(7, SHAPES)
    pairs = F.make_pairs(qs, ts, range(len(qs)), range(len(ts)), "cpu")
    out = F.fwbw_plain(pairs, torch.from_numpy(mat), want_p=True)
    for b, (q, t) in enumerate(zip(qs, ts)):
        S = mat[t[:, None], q[None, :]]
        P = cells(out["p"].numpy(), pairs, b)
        np.testing.assert_allclose(P, jax_p(S), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(P, fwbw_oracle(S), rtol=2e-3, atol=1e-6)
        assert float(out["maxp"][b]) == P.max()


def test_mac_on_the_same_p_is_the_jax_packages_bit_for_bit():
    """The port's MAC on the JAX package's P: the same states, score and
    first maximum cell, on pairs batched together with ragged lengths."""
    import jax.numpy as jnp
    from mmseqs2_tpu.ops.fwbw import _mac
    qs, ts, mat = random_pairs(11, SHAPES + [(96, 80), (33, 120)])
    pairs = F.make_pairs(qs, ts, range(len(qs)), range(len(ts)), "cpu")
    Ps = [jax_p(mat[t[:, None], q[None, :]]) for q, t in zip(qs, ts)]
    p_in = torch.from_numpy(np.concatenate([P.reshape(-1) for P in Ps]))
    for mact in (0.035, 0.3):
        out = F.fwbw_plain(pairs, torch.from_numpy(mat), mact=mact,
                           p_in=p_in)
        for b, P in enumerate(Ps):
            bt, best, bi, bj = _mac(jnp.asarray(P), P.shape[0], P.shape[1],
                                    mact=mact)
            assert np.array_equal(cells(out["bt"].numpy(), pairs, b),
                                  np.asarray(bt))
            assert out["score"][b].item() == float(best)
            assert (int(out["bi"][b]), int(out["bj"][b])) == (int(bi),
                                                              int(bj))


def test_backtrace_matches_fwbw_align_batch():
    """The port end to end (plain P, MAC, the host walk of every pair at
    once) against the JAX package's fwbw_align_batch."""
    from mmseqs2_tpu.ops.fwbw import fwbw_align_batch
    qs, ts, mat = random_pairs(3, [(30, 30), (50, 41), (17, 60), (64, 64)])
    # related pairs, so that the alignments have gaps and long runs of M
    ts[3] = np.concatenate([qs[3][:20], qs[3][25:], qs[3][:5]])
    pairs = F.make_pairs(qs, ts, range(4), range(4), "cpu")
    out = F.fwbw_plain(pairs, torch.from_numpy(mat))
    walk = F.backtrace(out["bt"].numpy(), pairs.cell_off.numpy(),
                       pairs.q_len.numpy(), out["bi"].numpy(),
                       out["bj"].numpy())
    for b, (q, t) in enumerate(zip(qs, ts)):
        want = fwbw_align_batch([mat[t[:, None], q[None, :]]], [len(t)],
                                [len(q)])[0]
        for k in ("cigar", "q_start", "q_end", "t_start", "t_end"):
            assert walk[k][b] == want[k], (b, k)
        # a sum of P - mact along the path: P's relative error
        assert float(out["score"][b]) == pytest.approx(want["score_mac"],
                                                       rel=1e-5, abs=1e-5)
    assert "I" in walk["cigar"][3] or "D" in walk["cigar"][3]


def test_identity_pair_aligns_whole():
    rng = np.random.default_rng(1)
    n = 50
    seq = rng.integers(0, 20, size=n)
    mat = rng.integers(-4, 2, size=(21, 21)).astype(np.float32)
    mat[np.arange(20), np.arange(20)] = 8.0
    pairs = F.make_pairs([seq], [seq], [0], [0], "cpu")
    out = F.fwbw(pairs, torch.from_numpy(mat))
    walk = F.backtrace(out["bt"].numpy(), pairs.cell_off.numpy(),
                       pairs.q_len.numpy(), out["bi"].numpy(),
                       out["bj"].numpy(), seq, np.zeros(1, np.int64), seq,
                       np.zeros(1, np.int64))
    assert walk["cigar"] == ["M" * n]
    assert (walk["q_start"][0], walk["t_start"][0]) == (0, 0)
    assert (walk["q_end"][0], walk["t_end"][0]) == (n - 1, n - 1)
    assert walk["identities"][0] == n


def test_wrapper_checks_its_inputs():
    qs, ts, mat = random_pairs(2, [(5, 6)])
    pairs = F.make_pairs(qs, ts, [0], [0], "cpu")
    with pytest.raises(ValueError, match="mat"):
        F.fwbw(pairs, torch.from_numpy(mat.astype(np.float64)))
    with pytest.raises(ValueError, match="p_in"):
        F.fwbw(pairs, torch.from_numpy(mat), p_in=torch.zeros(7))
    assert F.fwbw.launches == 0


def subset_aln(tmp_path, keys):
    out = str(tmp_path / "alnsub")
    with DBReader(str(G / "alnsub")) as r, \
            DBWriter(out, r.base_type, r.extended_type) as w:
        for k in keys:
            w.write(k, r.get_data(r.get_id(k)))
    return out


def records(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i).decode().strip().split("\n")
                for i in range(r.size)}


def test_command_matches_the_reference_golden(tmp_path, on_cpu,
                                              monkeypatch):
    """Five queries of the golden (lengths 59-472; a batch budget that puts
    them in three batches): every integer field, the cigar and the seq-id
    equal the reference's, the MAC score within 3."""
    keys = [0, 2, 3, 4, 6]
    monkeypatch.setattr(fwbw_cmd, "BATCH_CELLS", 200_000)
    fwbw_cmd.reset_stats()
    assert cli.main(["fwbw", str(TOY / "qdb"), str(TOY / "qdb"),
                     subset_aln(tmp_path, keys), str(tmp_path / "fw")]) == 0
    got, want = records(tmp_path / "fw"), records(G / "reffw")
    assert sorted(got) == keys
    for k in keys:
        assert len(got[k]) == len(want[k])
        for ra, rb in zip(got[k], want[k]):
            fa, fb = ra.split("\t"), rb.split("\t")
            assert fa[0] == fb[0] and fa[2:] == fb[2:], (ra, rb)
            assert abs(int(fa[1]) - int(fb[1])) <= 3, (ra, rb)
    st = fwbw_cmd.STATS
    assert st["queries"] == 5 and st["pairs"] == 5 and st["batches"] >= 3
    assert st["launches"] == 0          # the CPU runs the plain version


def test_command_matches_the_jax_command(tmp_path, on_cpu):
    """Two queries, each with three targets of the toy set: the port's
    records equal the JAX command's byte for byte."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    aln = str(tmp_path / "aln3")
    with DBWriter(aln, 5) as w:         # DBTYPE_ALIGNMENT_RES
        w.write(0, b"0\t0\n6\t0\n11\t0\n")
        w.write(6, b"6\t0\n0\t0\n40\t0\n")
    args = [str(TOY / "qdb"), str(TOY / "qdb"), aln]
    assert cli.main(["fwbw", *args, str(tmp_path / "port")]) == 0
    cmd = get_command("fwbw")
    par = Params().parse([*args, str(tmp_path / "jax")], cmd, cmd.min_db,
                         cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    got, want = records(tmp_path / "port"), records(tmp_path / "jax")
    assert got == want and all(len(v) >= 1 for v in got.values())


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
q, aln, out = sys.argv[1:4]
assert main(["fwbw", q, q, aln, out]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_fwbw_loads_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN,
                        str(TOY / "qdb"), subset_aln(tmp_path, [0]),
                        str(tmp_path / "fw")], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout


def test_launch_plan_covers_every_pair_once(monkeypatch):
    """The kernels' launch plan: every pair in exactly one form (a warp for
    queries of at most WARP_COLS residues, a block past it), each form by
    target length, longest first, and the kernels' indexing (the first
    n_block blocks a pair each, then wb pairs a block) reaching every pair
    once, so that outputs written by pair index come back in input order."""
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.integers(1, 513, 252), [512, 513, 1, 2000]])
    t = rng.integers(1, 900, len(q))
    plan = F.launch_plan(q, t)
    order = plan.order
    assert sorted(order.tolist()) == list(range(len(q)))
    blocks, warps = order[:plan.n_block], order[plan.n_block:]
    assert plan.warp_cols == F.WARP_COLS
    assert set(blocks.tolist()) == set(np.flatnonzero(q > F.WARP_COLS))
    for part in (blocks, warps):
        assert (np.diff(t[part]) <= 0).all()
    assert plan.kmax == F.KMAX and plan.wb == -(-2000 // (32 * 8))
    assert (q[blocks] <= 32 * 8 * plan.wb).all()
    seen = []
    for b in range(plan.blocks):
        if b < plan.n_block:
            seen.append(order[b])
            continue
        for w in range(plan.wb):
            idx = plan.n_block + (b - plan.n_block) * plan.wb + w
            if idx < len(q):
                seen.append(order[idx])
    assert sorted(seen) == list(range(len(q)))
    assert plan.forms() == dict(warp=len(warps), block=len(blocks),
                                block_warps=plan.wb, kmax=plan.kmax,
                                warp_cols=F.WARP_COLS)
    # a small batch takes the same forms; WARP_COLS moves their edge
    small = F.launch_plan(q[:40], t[:40])
    assert small.warp_cols == F.WARP_COLS
    assert set(small.order[:small.n_block].tolist()) == set(
        np.flatnonzero(q[:40] > F.WARP_COLS))
    with monkeypatch.context() as m:
        m.setattr(F, "WARP_COLS", 256)
        half = F.launch_plan(q[:40], t[:40])
    assert half.warp_cols == 256
    assert set(half.order[:half.n_block].tolist()) == set(
        np.flatnonzero(q[:40] > 256))
    # no long query: 4 warp-form pairs a block; one past 4,096 columns:
    # 32 columns a lane
    short = F.launch_plan([5, 200], [7, 7])
    assert (short.n_block, short.wb, short.blocks) == (0, F.WARPS_PER_BLOCK,
                                                      1)
    wide = F.launch_plan([9000, 600, 100], [3, 8, 1])
    assert (wide.kmax, wide.wb, wide.n_block) == (F.KMAX_WIDE, 9, 2)
    assert wide.order.tolist() == [1, 0, 2]
    mid = F.launch_plan([3000, 600], [3, 8])      # past 2,048: 16 a lane
    assert (mid.kmax, mid.wb) == (F.KMAX, 6)
    longest = F.launch_plan([F.MAX_Q, 12289], [3, 4])
    assert (longest.kmax, longest.wb) == (F.KMAX_WIDE,
                                          F.BLOCK_WARPS[F.KMAX_WIDE])
    with pytest.raises(ValueError, match="at most"):
        F.launch_plan([F.MAX_Q + 1], [3])


def test_make_pairs_plans_the_launch():
    """make_pairs builds the plan from its host lengths (the wrapper then
    copies nothing from the card); past MAX_Q it builds none (the plain
    version takes any length)."""
    qs, ts, _ = random_pairs(6, [(5, 9), (7, 600)])
    pairs = F.make_pairs(qs, ts, [1, 0], [0, 1], "cpu")
    assert pairs.q_len.tolist() == [600, 9]     # 600 > WARP_COLS
    assert pairs.plan.order.tolist() == [0, 1] and pairs.plan.n_block == 1
    assert pairs.plan.order_dev.tolist() == [0, 1]
    long_q = [np.zeros(F.MAX_Q + 1, np.int64)]
    assert F.make_pairs(long_q, ts[:1], [0], [0], "cpu").plan is None


def kernel_against_plain(shapes, seed=5, related=False, **params):
    """B5 on the card against its plain version on the card for one batch
    of (tlen, qlen) pairs, in the given order, with fwbw's params (go, ge,
    temp, mact; the defaults if none): P within the stated tolerance; the
    kernel's MAC fed the plain P gives the plain version's states, score
    and maximum bit for bit, and hands that P back with want_p."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from mmseqs2_tpu_torch.data.submat import get_submat
    # the command's matrix: a matrix of positive mean makes the f32
    # partition function of long pairs lose its precision in both versions
    qs, ts, _ = random_pairs(seed, shapes)
    if related:       # pairs that align, so that P has long runs near 1
        for b, (tl, ql) in enumerate(shapes):
            t = np.resize(qs[b], tl).copy()
            mut = np.random.default_rng(seed + b).random(tl) < 0.3
            t[mut] = ts[b][mut]
            ts[b] = t
    mat = np.asarray(get_submat("blosum62.out", 2.0, 0.0).sub_matrix,
                     np.float32)
    pairs = F.make_pairs(qs, ts, range(len(qs)), range(len(qs)), "cuda")
    m = torch.from_numpy(mat).cuda()
    want = F.fwbw_plain(pairs, m, want_p=True, **params)
    got = F.fwbw(pairs, m, want_p=True, **params)
    torch.testing.assert_close(got["p"], want["p"], rtol=1e-4, atol=1e-7)
    fed = F.fwbw(pairs, m, p_in=want["p"], want_p=True, **params)
    for k in ("bt", "score", "bi", "bj", "maxp", "p"):
        assert torch.equal(fed[k], want[k]), k
    fed = F.fwbw(pairs, m, p_in=want["p"], **params)
    assert "p" not in fed and torch.equal(fed["bt"], want["bt"])
    return pairs.plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (300, 292), (1, 700),
                                   (200, 512), (200, 513), (50, 1),
                                   (1, 1)])
def test_kernel_matches_the_plain_version(shape):
    """A pair of each shape, its transpose and a 37 x 41 pair: the warp
    form (queries up to 512), the block form (513 and past), a query and
    a target of one residue."""
    kernel_against_plain([shape, (shape[1], shape[0]), (37, 41)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shortest_first", "both_forms",
                                  "related", "wide", "past_12288", "max_q",
                                  "large_batch"])
def test_kernel_forms_and_order(case):
    """Batches the plan reorders: targets shortest first, both forms in one
    launch with several warps a block, related pairs in both forms, a query
    past 4,096 residues (32 columns a lane), past 12,288 (13 warps) and of
    MAX_Q residues (16 warps, the most shared memory a block takes), and a
    batch of 256 pairs at the warp form's edge (queries of 512 residues a
    warp, 513 a block; 8, 12 and 16 columns a lane)."""
    if case == "shortest_first":
        plan = kernel_against_plain([(5, 200), (60, 190), (200, 210),
                                     (400, 205), (401, 1)])
        assert plan.order.tolist() == [4, 3, 2, 1, 0]
    elif case == "both_forms":
        plan = kernel_against_plain([(30, 512), (90, 513), (20, 1100),
                                     (120, 256), (7, 257), (64, 40)])
        assert plan.forms()["block"] == 4 and plan.wb == 5
    elif case == "related":
        plan = kernel_against_plain([(250, 260), (300, 700), (80, 90)],
                                    related=True)
        assert plan.forms()["block"] == 2
    elif case == "wide":
        plan = kernel_against_plain([(12, 8300), (9, 40), (30, 4100)])
        assert plan.kmax == F.KMAX_WIDE
    elif case == "past_12288":
        plan = kernel_against_plain([(15, 12289), (3, 5000), (20, 30)])
        assert (plan.kmax, plan.wb) == (F.KMAX_WIDE, 13)
    elif case == "max_q":
        plan = kernel_against_plain([(20, F.MAX_Q), (9, 40)])
        assert (plan.kmax, plan.wb) == (F.KMAX_WIDE,
                                        F.BLOCK_WARPS[F.KMAX_WIDE])
    else:
        q = np.resize([512, 513, 384, 300, 100], 256)
        t = np.resize([40, 7, 61, 1, 33, 50], 256)
        plan = kernel_against_plain(list(zip(t, q)))
        assert plan.warp_cols == F.WARP_COLS
        assert plan.forms()["block"] == int((q > F.WARP_COLS).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("ge,temp", [(-1.0, 2.0), (-1.0, 10.0)])
@pytest.mark.parametrize("shapes", [[(60, 700), (40, 300), (30, 1500)],
                                    [(20, 5000), (9, 600)]])
def test_kernel_gap_extend_and_temperature(shapes, ge, temp):
    """Another gap extension and temperature than the defaults, where
    e^{ge/T} to a warp's columns (255 and more) does not underflow to 0:
    both forms at 8 columns a lane, and the 32-column form."""
    kernel_against_plain(shapes, ge=ge, temp=temp)
