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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (300, 292), (1, 700)])
def test_kernel_matches_the_plain_version(shape):
    """B5 on the card against its plain version on the card: P within the
    stated tolerance; the kernel's MAC fed the plain P gives the plain
    version's states, score and maximum bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from mmseqs2_tpu_torch.data.submat import get_submat
    # the command's matrix: a matrix of positive mean makes the f32
    # partition function of long pairs lose its precision in both versions
    qs, ts, _ = random_pairs(5, [shape, (shape[1], shape[0]), (37, 41)])
    mat = np.asarray(get_submat("blosum62.out", 2.0, 0.0).sub_matrix,
                     np.float32)
    pairs = F.make_pairs(qs, ts, range(3), range(3), "cuda")
    m = torch.from_numpy(mat).cuda()
    want = F.fwbw_plain(pairs, m, want_p=True)
    got = F.fwbw(pairs, m, want_p=True)
    torch.testing.assert_close(got["p"], want["p"], rtol=1e-4, atol=1e-7)
    fed = F.fwbw(pairs, m, p_in=want["p"])
    for k in ("bt", "score", "bi", "bj", "maxp"):
        assert torch.equal(fed[k], want[k]), k
