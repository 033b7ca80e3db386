"""The port's clustering modules (`clust`, `rescorediagonal`, `kmermatcher`,
`align2clust`, `clusthash`) with the CPU requested: the first three against
the reference MMseqs2 goldens of tests/golden/toy, key by key; align2clust
(whose reference depends on a stubbed-out aligner, so no golden exists) by
its clustering semantics and against the JAX package's align2clust on the
same inputs; clusthash against the JAX package's."""

import pathlib

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import align2clust
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"


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


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_clust_parity(tmp_path, on_cpu, mode):
    out = tmp_path / f"clu{mode}"
    run(["clust", GOLDEN / "qdb", GOLDEN / "aln", out, "--cluster-mode",
         mode])
    assert entries_by_key(out) == entries_by_key(GOLDEN / f"clu{mode}")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rescorediagonal_parity(tmp_path, on_cpu, mode):
    out = tmp_path / f"resc{mode}"
    run(["rescorediagonal", GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "pref",
         out, "--rescore-mode", mode])
    got = entries_by_key(out)
    want = entries_by_key(GOLDEN / f"resc{mode}")
    for k in want:
        assert got[k] == want[k], f"query {k}:\n{got[k]!r}\n!=\n{want[k]!r}"


def test_kmermatcher_parity(tmp_path, on_cpu):
    """The longest-center (linclust v1) path; golden made with
    --include-adjacency 0 --include-count-table 0."""
    out = tmp_path / "kmp"
    run(["kmermatcher", GOLDEN / "qdb", out, "--linclust-version", "1"])
    assert entries_by_key(out) == entries_by_key(GOLDEN / "kmpref")


@pytest.mark.parametrize("flags,golden", [
    ([], "km_default"),                            # adjacency + count-table
    (["--include-adjacency", "0"], "km_ct"),       # count-table only
    (["--include-count-table", "0"], "km_adj"),    # adjacency only
])
def test_kmermatcher_v2_parity(tmp_path, on_cpu, flags, golden):
    """The linclust v2 center-swapping chain (the reference default)."""
    out = tmp_path / "kmp2"
    run(["kmermatcher", GOLDEN / "qdb", out] + flags)
    assert entries_by_key(out) == entries_by_key(GOLDEN / golden)


@pytest.fixture(scope="module")
def dup_db(tmp_path_factory):
    """The first six toy sequences, each twice (an exact copy under another
    header), with the port's self prefilter."""
    import os
    tmp = tmp_path_factory.mktemp("a2c")
    txt = (GOLDEN / "QUERY.fasta").read_text()
    recs = [">" + r for r in txt.split(">") if r.strip()][:6]
    out = []
    for r in recs:
        head, _, body = r.partition("\n")
        out.append(f"{head}\n{body}")
        out.append(f"{head}_copy\n{body}")      # exact duplicate
    fasta = tmp / "dup.fasta"
    fasta.write_text("".join(out))
    db = str(tmp / "db")
    pref = str(tmp / "pref")
    old = os.environ.get(ENV)
    os.environ[ENV] = "cpu"
    try:
        run(["createdb", fasta, db])
        run(["prefilter", db, db, pref, "--add-self-matches", "1",
             "--threads", "1", "-s", "4"])
    finally:
        if old is None:
            del os.environ[ENV]
        else:
            os.environ[ENV] = old
    return db, pref


def clusters_of(path):
    out = {}
    with DBReader(str(path)) as r:
        for i in range(r.size):
            mem = [int(x) for x in r.get_data(i).decode().split()]
            out[r.get_db_key(i)] = mem
    return out


def test_align2clust_duplicates(dup_db, tmp_path, on_cpu):
    """Every sequence is assigned once, each duplicate joins its twin, and
    the clusters equal the JAX package's on the same prefilter."""
    db, pref = dup_db
    args = ["--min-seq-id", "0.9", "-c", "0.8", "--threads", "1"]
    align2clust.reset_stats()
    run(["align2clust", db, pref, tmp_path / "clu"] + args)
    clus = clusters_of(tmp_path / "clu")
    all_members = [m for v in clus.values() for m in v]
    assert sorted(all_members) == list(range(12))
    with DBReader(db + "_h") as h:
        name = {h.get_db_key(i): h.get_data(i).decode().split()[0]
                for i in range(h.size)}
    owner = {m: rep for rep, mem in clus.items() for m in mem}
    for k, nm in name.items():
        base = nm.replace("_copy", "")
        twin = [k2 for k2, n2 in name.items()
                if n2.replace("_copy", "") == base and k2 != k]
        assert twin and owner[k] == owner[twin[0]], (nm, owner)
    st = align2clust.STATS
    assert st["reps"] == len(clus)
    assert st["ungapped_accepted"] + st["gapped_accepted"] == 12 - len(clus)
    run_jax("align2clust", [db, pref, tmp_path / "jax"] + args)
    assert entries_by_key(tmp_path / "clu") == \
        entries_by_key(tmp_path / "jax")


def test_align2clust_aln_output(dup_db, tmp_path, on_cpu):
    """--include-align-files: a record with a CIGAR for every member of its
    cluster, equal to the JAX package's records."""
    db, pref = dup_db
    args = ["--min-seq-id", "0.9", "-c", "0.8", "--threads", "1",
            "--include-align-files", "1", "-a", "1", "--alignment-mode", "3"]
    out = tmp_path / "clu"
    run(["align2clust", db, pref, out] + args)
    clus = clusters_of(out)
    aln = entries_by_key(str(out) + "_aln")
    for rep, data in aln.items():
        keys = set()
        for line in data.decode().strip().split("\n"):
            parts = line.split("\t")
            keys.add(int(parts[0]))
            assert parts[-1].endswith("M")     # cigar present
        assert set(clus[rep]) <= keys | {rep}
    run_jax("align2clust", [db, pref, tmp_path / "jax"] + args)
    assert aln == entries_by_key(str(tmp_path / "jax") + "_aln")


def test_align2clust_gapped_fallback_matches_jax(tmp_path, on_cpu):
    """At 50% identity over the golden prefilter of the first 100 toy
    queries some pairs fail the ungapped rescore and go to the gapped
    aligner: the port's clusters equal the JAX package's, through gapped
    calls of two read-backs at most each."""
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.writer import DBWriter
    golden = entries_by_key(GOLDEN / "pref")
    pref = tmp_path / "pref"
    with DBWriter(str(pref), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in range(100):
            w.write(k, golden[k])
    args = ["--min-seq-id", "0.5", "-c", "0.5", "--threads", "1"]
    align2clust.reset_stats()
    aligner.reset_stats()
    run(["align2clust", GOLDEN / "qdb", pref, tmp_path / "clu"] + args)
    calls = align2clust.STATS["gapped_calls"]
    assert calls > 0
    assert calls <= aligner.STATS["readbacks"] <= 2 * calls
    run_jax("align2clust", [GOLDEN / "qdb", pref, tmp_path / "jax"] + args)
    assert entries_by_key(tmp_path / "clu") == \
        entries_by_key(tmp_path / "jax")


@pytest.mark.parametrize("extra", [[], ["--min-seq-id", "0.5"]])
def test_clusthash_matches_the_jax_package(tmp_path, on_cpu, extra):
    run(["clusthash", GOLDEN / "qdb", tmp_path / "port"] + extra)
    run_jax("clusthash", [GOLDEN / "qdb", tmp_path / "jax"] + extra)
    got = entries_by_key(tmp_path / "port")
    assert got == entries_by_key(tmp_path / "jax") and len(got) == 500


@pytest.mark.parametrize("length", [0, 1, 7, 300, 40_000])
def test_poly_hash_matches_the_jax_loop(length):
    """The port hashes a sequence as one dot product with the powers of 31
    mod 2^64; the JAX package's loop (Util::hash) gives the same value."""
    import numpy as np
    from mmseqs2_tpu.cluster import kmermatcher as jkm
    from mmseqs2_tpu_torch.cluster import kmermatcher as km
    rng = np.random.default_rng(length)
    for dtype in (np.uint8, np.int64):
        seq = rng.integers(0, 21, length).astype(dtype)
        got = km.poly_hash(seq)
        assert got == jkm.poly_hash(seq) and isinstance(got, np.uint64)


def test_select_kmers_matches_the_jax_package():
    """The port finds the reference's histogram threshold (the
    kmer_considered-th smallest 16-bit hash) by a partition instead of a
    65,536-bin histogram; the selected k-mers, positions and hashes equal
    the JAX package's on random sequences with X runs, for consecutive and
    spaced seeds."""
    import numpy as np
    from mmseqs2_tpu.cluster import kmermatcher as jkm
    from mmseqs2_tpu_torch.cluster import kmermatcher as km
    from mmseqs2_tpu_torch.prefilter.kmer_index import pattern_offsets
    rng = np.random.default_rng(7)
    selected = 0
    for trial in range(400):
        length = int(rng.integers(1, 400))
        k = int(rng.choice([5, 10, 14]))
        alpha = int(rng.choice([13, 21]))
        seq = rng.integers(0, alpha, length).astype(np.uint8)
        seq[rng.random(length) < rng.choice([0.0, 0.1])] = alpha - 1
        considered = int(rng.integers(1, 60))
        shift = int(rng.integers(0, 70))
        kw = {}
        if trial % 2:
            offsets, span = pattern_offsets(k, True)
            kw = dict(offsets=np.asarray(offsets), span=int(span))
        want = jkm.select_kmers(seq, k, alpha, alpha - 1, considered, shift,
                                **kw)
        got = km.select_kmers(seq, k, alpha, alpha - 1, considered, shift,
                              **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), trial
        selected += len(got[0])
    assert selected > 1000


@pytest.mark.parametrize("spaced", [False, True])
def test_kmer_entries_match_the_jax_package(spaced):
    """kmermatcher v2's entry table (k-mers, ids, positions, 16-bit hashes,
    lengths, the 3 residues either side of each k-mer) equals the JAX
    package's, on sequences as short as one residue."""
    import numpy as np
    from mmseqs2_tpu.cluster import kmermatcher_chain as jkmc
    from mmseqs2_tpu_torch.cluster import kmermatcher_chain as kmc
    from mmseqs2_tpu_torch.prefilter.kmer_index import pattern_offsets
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 13, int(rng.integers(1, 300))).astype(np.uint8)
            for _ in range(200)]
    seqs += [rng.integers(0, 13, n).astype(np.uint8) for n in range(1, 30)]
    keys = np.arange(len(seqs))
    offsets, span = pattern_offsets(10, spaced)
    args = (seqs, keys, 10, 13, 12, 21, 0.1, 67, np.asarray(offsets), span,
            True)
    want, got = jkmc.build_entries(*args), kmc.build_entries(*args)
    assert got["n"] == want["n"] > 0
    for name in ("kmer", "id", "pos", "h16", "len", "adj"):
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name
