"""The port's banded nucleotide aligner with the CPU requested: its ksw2
oracle (`align/ksw2.py:extz2`) and its native batch core (`extz2_batch`,
native/ksw2_batch.cpp built into the port's build directory) against the
JAX package's `extz2`, field by field and cigar by cigar, at the flags the
aligner uses; a failed build raises with the compiler's output; the
`NuclAligner` against the JAX package's on the nucleotide goldens' pairs
(forward, reverse-complement and wrapped), and the `align` command's
nucleotide branch against the reference goldens (`n_aln`, the wrapped
`refw`) and the JAX package (its per-pair path, a PREFILTER_REV_RES
input). JAX is imported only inside the tests that compare with it."""

import pathlib

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.align import ksw2
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
NUCL = REPO / "tests" / "golden" / "nucl"
WRAP = REPO / "tests" / "golden" / "wrap"

# the nucleotide matrix's 5 x 5 scores (A C G T N) at 1 bit, as the aligner
# passes them, and tests/test_ksw2_batch.py's parameters: m, q, e, w, zdrop
MAT = [2, -3, -3, -3, 0, -3, 2, -3, -3, 0, -3, -3, 2, -3, 0,
       -3, -3, -3, 2, 0, 0, 0, 0, 0, 0]
ARGS = (5, 4, 2, 64, 40)
FIELDS = ("max", "max_q", "max_t", "mqe", "mqe_t", "mte", "mte_q",
          "score", "zdropped", "cigar")
FLAGS = {"score-only": ksw2.SCORE_ONLY | ksw2.EXTZ_ONLY,
         "extz-only": ksw2.EXTZ_ONLY, "global": 0}


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


def run_jax(name, args):
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    cmd = get_command(name)
    par = Params().parse([str(a) for a in args], cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def pairs(seed, n):
    """n pairs at each of five similarities, lengths 2-400 (the JAX
    package's test_ksw2_batch recipe)."""
    rng = np.random.default_rng(seed)
    out = []
    for sim in (0.99, 0.9, 0.75, 0.5, 0.3):
        for _ in range(n):
            ql, tl = int(rng.integers(2, 400)), int(rng.integers(2, 400))
            t = rng.integers(0, 4, size=tl)
            q = (t[:ql].copy() if ql <= tl else
                 np.concatenate([t, rng.integers(0, 4, size=ql - tl)]))
            mut = rng.random(ql) < (1 - sim)
            q[mut] = rng.integers(0, 4, size=int(mut.sum()))
            out.append((q.astype(np.int64), t.astype(np.int64)))
    return out


def fields(ez):
    return {f: getattr(ez, f) for f in FIELDS}


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_extz2_equals_jax(flag):
    """The port's oracle is the JAX package's extz2."""
    from mmseqs2_tpu.align import ksw2 as jksw2
    for q, t in pairs(21, 2):
        got = ksw2.extz2(q, t, MAT, *ARGS, FLAGS[flag])
        want = jksw2.extz2(q, t, MAT, *ARGS, FLAGS[flag])
        assert fields(got) == fields(want)


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_extz2_batch_equals_jax_extz2(flag):
    """The native batch core gives the JAX package's extz2 on every pair:
    scores, end positions, the Z-drop record and the cigar."""
    from mmseqs2_tpu.align import ksw2 as jksw2
    ps = pairs(11, 5)
    got = ksw2.extz2_batch([p[0] for p in ps], [p[1] for p in ps], MAT,
                           *ARGS, FLAGS[flag])
    assert len(got) == len(ps)
    for b, (q, t) in enumerate(ps):
        want = jksw2.extz2(q, t, MAT, *ARGS, FLAGS[flag])
        assert fields(got[b]) == fields(want), b


@pytest.mark.parametrize("case", ["unbanded", "narrow band", "no-op",
                                  "empty batch", "long cigars"])
def test_extz2_batch_edges_equal_oracle(case):
    """The batch core against the port's oracle where its own code differs:
    w < 0 (the whole matrix), a band of 1, an empty sequence and a matrix
    whose worst score exceeds twice the gap cost (both return at once),
    no pair, and cigars longer than the first buffer (the retry)."""
    flag = ksw2.EXTZ_ONLY
    ps = pairs(5, 1)
    args, mat = list(ARGS), MAT
    if case == "unbanded":
        args[3] = -1
    elif case == "narrow band":
        args[3] = 1
    elif case == "no-op":
        ps = [(np.zeros(0, np.int64), ps[0][1]), ps[1]]
        mat = [v if v >= 0 else -20 for v in MAT]
    elif case == "empty batch":
        assert ksw2.extz2_batch([], [], MAT, *ARGS, flag) == []
        return
    else:
        rng = np.random.default_rng(3)
        ps = [(rng.integers(0, 4, 2000), rng.integers(0, 4, 2000))
              for _ in range(4)]
        args[1:3] = [1, 1]
    got = ksw2.extz2_batch([p[0] for p in ps], [p[1] for p in ps], mat,
                           *args, flag)
    for b, (q, t) in enumerate(ps):
        assert fields(got[b]) == fields(ksw2.extz2(q, t, mat, *args, flag))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No numpy fallback: a source the compiler refuses raises, and the
    error carries the compiler's message."""
    bad = tmp_path / "ksw2_batch.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(ksw2, "SOURCE", bad)
    monkeypatch.setattr(ksw2, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(ksw2, "_LIB", None)
    with pytest.raises(RuntimeError, match="cannot build") as e:
        ksw2.extz2_batch(*[[x] for x in pairs(1, 1)[0]], MAT, *ARGS,
                         ksw2.EXTZ_ONLY)
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_library_keyed_by_source_and_flags(monkeypatch):
    """The build lands in the port's build directory under a name that
    changes with the source's bytes and the flags."""
    from mmseqs2_tpu_torch import BUILD_DIR
    path = ksw2.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("ksw2_batch_")
    monkeypatch.setattr(ksw2, "CXXFLAGS", ksw2.CXXFLAGS + ["-g"])
    assert ksw2.library_path() != path


def golden_pairs(n_queries):
    """(query, [(target, diagonal, reversed)]) of the first n_queries
    entries of the nucleotide prefilter golden, as numeric arrays."""
    from mmseqs2_tpu_torch.commands.common import (EncodedDB,
                                                   parse_prefilter_entry)
    from mmseqs2_tpu_torch.data.submat import get_submat
    submat = get_submat("nucleotide.out", 1.0, 0.0)
    q = EncodedDB(DBReader(str(NUCL / "n_query_seqs")), submat)
    t = EncodedDB(DBReader(str(NUCL / "ndb")), submat)
    out = []
    with DBReader(str(NUCL / "n_pref")) as pref:
        for i in range(min(n_queries, pref.size)):
            keys, scores, diags = parse_prefilter_entry(pref.get_data(i))
            qnum = q.seq_num(q.reader.get_id(pref.get_db_key(i)))
            hits = [(t.seq_num(t.reader.get_id(k)), int(d), s < 0)
                    for k, s, d in zip(keys, scores, diags)]
            out.append((qnum, hits))
    return submat, out


@pytest.mark.parametrize("mode", ["forward", "reverse", "wrapped"])
def test_nucl_aligner_equals_jax(mode):
    """align_pairs (the batch path) and align (one pair) of the port's
    NuclAligner give the JAX aligner's per-pair results, reused-buffer
    staleness included: every query of the golden's first 16 against its
    prefilter hits, each hit forward, as its reverse complement, or with
    the query doubled for wrapped scoring."""
    from mmseqs2_tpu.align.nucl_aligner import NuclAligner as JaxAligner
    from mmseqs2_tpu.ops.evalue import EvalueComputation as JaxEvalue
    from mmseqs2_tpu_torch.align.nucl_aligner import NuclAligner
    from mmseqs2_tpu_torch.ops.evalue import EvalueComputation
    submat, queries = golden_pairs(16)
    residues = DBReader(str(NUCL / "ndb")).total_residues()
    port = NuclAligner(submat, 5, 2, 40,
                       EvalueComputation(residues, submat, 5, 2))
    single = NuclAligner(submat, 5, 2, 40,
                         EvalueComputation(residues, submat, 5, 2))
    ref = JaxAligner(submat, 5, 2, 40, JaxEvalue(residues, submat, 5, 2))
    wrapped = mode == "wrapped"
    n = 0
    for qnum, hits in queries:
        if not hits:
            continue
        qq = np.concatenate([qnum, qnum]) if wrapped else qnum
        for a in (port, single, ref):
            a.init_query(qq)
        rev = [mode == "reverse"] * len(hits)
        got = port.align_pairs([h[0] for h in hits], [h[1] for h in hits],
                               rev, wrapped=wrapped)
        for (tnum, diag, _), r, g in zip(hits, rev, got):
            want = ref.align(tnum, diag, r, wrapped=wrapped)
            one = single.align(tnum, diag, r, wrapped=wrapped)
            for res in (g, one):
                assert vars(res) == vars(want)
            n += 1
    assert n >= 16


def test_align_nucl_golden(tmp_path, on_cpu):
    """align --alignment-mode 3 of the extracted frames against ndb equals
    the reference's n_aln (BandedNucleotideAligner) on every query."""
    out = tmp_path / "aln"
    run(["align", NUCL / "n_query_seqs", NUCL / "ndb", NUCL / "n_pref", out,
         "--alignment-mode", "3", "--max-seq-len", "10000"])
    assert entries_by_key(out) == entries_by_key(NUCL / "n_aln")


def test_align_wrapped_scoring_golden(tmp_path, on_cpu):
    """align --wrapped-scoring of a rotated circular pair equals the
    reference's refw byte for byte."""
    out = tmp_path / "out"
    run(["align", WRAP / "qd", WRAP / "td", WRAP / "pf", out, "-e", "1e5",
         "--threads", "1", "-a", "--wrapped-scoring"])
    assert out.read_bytes() == (WRAP / "refw").read_bytes()


@pytest.mark.parametrize("case", ["per-pair path", "reversed hits"])
def test_align_nucl_equals_jax(tmp_path, on_cpu, case):
    """The per-pair path (--max-accept: the batch would break the early
    exit) on the golden frames' first 12 prefilter entries, and a
    PREFILTER_REV_RES input (a sequence against its reverse complement,
    the hit's negative score marking it reversed), each equal to the JAX
    package's align."""
    if case == "per-pair path":
        pref = tmp_path / "pref12"
        with DBReader(str(NUCL / "n_pref")) as r, \
                DBWriter(str(pref), r.base_type) as w:
            for i in range(12):
                w.write(r.get_db_key(i), r.get_data(i))
        dbs = [NUCL / "n_query_seqs", NUCL / "ndb", pref]
        extra = ["--alignment-mode", "3", "--max-accept", "2"]
    else:
        dbs = [WRAP / "qd2", WRAP / "td2", WRAP / "pr"]
        extra = ["-a", "-e", "1e5"]
    run(["align", *dbs, tmp_path / "port", *extra])
    run_jax("align", [*dbs, tmp_path / "jax", *extra])
    got = entries_by_key(tmp_path / "port")
    assert got == entries_by_key(tmp_path / "jax")
    assert any(got.values())
