"""The port's context-specific pseudocounts (`profile/cs.py`, B9: the
context-score product) and `sequence2profile`, with the CPU requested.

- The CRF text format round trip (`dump_crf`/`load_crf`).
- `sequence2profile` with the default synthetic library (20 contexts: the
  numpy product in both packages) equal byte for byte to the JAX
  package's, on a sub-DB of the toy queries (the whole toy set in the slow
  test: its tantan masking takes about 15 s on one core in each package).
- A 512-context library made from a numpy seed: the port's
  `compute_sequence_cs` (the product by torch.matmul, here on the CPU)
  against the JAX package's `jnp.dot` branch, within rtol=1e-5,
  atol=1e-6 on the probabilities; and `sequence2profile --context-lib`
  with it, byte for byte.
- On the card (`cuda`, skipped here): the product on the card against the
  CPU's, the same tolerance.
"""

import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.profile import cs

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = REPO / "tests" / "golden" / "toy"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(ENV, "cpu")


def run(args):
    assert cli.main([str(a) for a in args]) == 0


def run_jax(args):
    from mmseqs2_tpu import cli as jcli
    assert jcli.main([str(a) for a in args]) == 0


def db_bytes(path):
    return tuple(pathlib.Path(f"{path}{suf}").read_bytes()
                 for suf in ("", ".index", ".dbtype"))


def seeded_library(k=512, wlen=13, seed=16):
    """A library of k contexts from a numpy seed (X's column 0 as the
    reference's)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, wlen, 21)).astype(np.float32)
    w[:, :, 20] = 0.0
    return (w, rng.normal(size=k).astype(np.float32),
            rng.normal(size=(k, 20)))


def query_subdb(tmp, n):
    keys = tmp / "keys"
    keys.write_text("".join(f"{k}\n" for k in range(n)))
    run(["createsubdb", keys, TOY / "qdb", tmp / "q"])
    return tmp / "q"


def test_crf_roundtrip():
    lib = cs.synthetic_library()
    lib2 = cs.load_crf(cs.dump_crf(lib))
    np.testing.assert_allclose(lib2.weights, lib.weights, atol=1e-3)
    np.testing.assert_allclose(lib2.pc, lib.pc, atol=1e-3)
    assert (lib2.size, lib2.wlen) == (lib.size, lib.wlen)


def test_crf_text_matches_the_jax_package():
    from mmseqs2_tpu.profile import cs as jcs
    w, b, pcw = seeded_library(k=24)
    text = cs.dump_crf(cs.ContextLibrary(w, b, pcw))
    assert text == jcs.dump_crf(jcs.ContextLibrary(w, b, pcw))
    mine, theirs = cs.load_crf(text), jcs.load_crf(text)
    for name in ("weights", "biases", "pc"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))


@pytest.mark.parametrize("n", [48, pytest.param(None,
                                                marks=pytest.mark.slow)])
def test_sequence2profile_matches_the_jax_package(tmp_path, on_cpu, n):
    """The default synthetic library (--pc-mode 1, as the JAX package's
    command test): bytes equal, index and dbtype too."""
    q = query_subdb(tmp_path, n) if n else TOY / "qdb"
    run(["sequence2profile", q, tmp_path / "port", "--pc-mode", 1])
    run_jax(["sequence2profile", q, tmp_path / "jax", "--pc-mode", 1])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")


def test_context_product_matches_jnp_dot(on_cpu):
    """512 contexts: the port's product (torch.matmul on the CPU, L padded
    to 64 and doubling) against the JAX package's jnp.dot branch, at
    lengths on both sides of the pads."""
    from mmseqs2_tpu.profile import cs as jcs
    w, b, pcw = seeded_library()
    mine, theirs = cs.ContextLibrary(w, b, pcw), jcs.ContextLibrary(w, b, pcw)
    rng = np.random.default_rng(5)
    cs.reset_stats()
    for L in (7, 64, 65, 300, 1030):
        seq = rng.integers(0, 21, size=L)
        got = cs.compute_sequence_cs(seq, mine, tau=0.9)
        want = jcs.compute_sequence_cs(seq, theirs, tau=0.9)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # the numpy product (small libraries) gives the same probabilities
        np.testing.assert_allclose(
            cs.compute_sequence_cs(seq, mine, device_product=False), want,
            rtol=RTOL, atol=ATOL)
    assert cs.STATS["products"] == 5
    assert cs.STATS["rows"] == 7 + 64 + 65 + 300 + 1030
    assert cs.STATS["rows_padded"] == 64 + 64 + 128 + 512 + 2048


def test_small_library_keeps_the_numpy_product(on_cpu):
    cs.reset_stats()
    seq = np.arange(40) % 21
    cs.compute_sequence_cs(seq, cs.synthetic_library())
    assert cs.STATS["products"] == 0


def test_sequence2profile_context_lib_matches_the_jax_package(tmp_path,
                                                              on_cpu):
    """--context-lib of a 512-context CRF file: the port's product by torch,
    the JAX package's by jnp.dot; profile bytes equal on 12 toy queries."""
    w, b, pcw = seeded_library()
    crf = tmp_path / "k512.crf"
    crf.write_text(cs.dump_crf(cs.ContextLibrary(w, b, pcw)))
    q = query_subdb(tmp_path, 12)
    cs.reset_stats()
    run(["sequence2profile", q, tmp_path / "port", "--context-lib", crf])
    assert cs.STATS["products"] == 12
    run_jax(["sequence2profile", q, tmp_path / "jax", "--context-lib", crf])
    assert db_bytes(tmp_path / "port") == db_bytes(tmp_path / "jax")
    with DBReader(str(tmp_path / "port")) as r:
        assert r.size == 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_context_product_on_the_card(cuda_device, monkeypatch):
    """The product on the card (f32, TF32 off) against the CPU's: the
    probabilities within the tolerance above; with TF32 on it raises."""
    w, b, pcw = seeded_library(k=4000)
    lib = cs.ContextLibrary(w, b, pcw)
    rng = np.random.default_rng(9)
    for L in (50, 333, 2100):
        seq = rng.integers(0, 21, size=L)
        monkeypatch.setenv(ENV, "cuda")
        card = cs.compute_sequence_cs(seq, lib)
        monkeypatch.setenv(ENV, "cpu")
        cpu = cs.compute_sequence_cs(seq, lib)
        np.testing.assert_allclose(card, cpu, rtol=RTOL, atol=ATOL)
    monkeypatch.setenv(ENV, "cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        cs.compute_sequence_cs(rng.integers(0, 21, size=80), lib)
