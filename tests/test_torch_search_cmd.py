"""The port's `prefilter`, `search`, `convertalis` and `easy-search`
(`python -m mmseqs2_tpu_torch`) against the reference MMseqs2 goldens of
tests/golden/toy, with the CPU requested: prefilter entries equal key by
key, convertalis byte-identical, easy-search equal line for line. Also: the
easy-search command loads neither JAX nor the JAX package, search
--prefilter-mode 1 and 2 equal the JAX package's search, and every branch
that is not ported says so and exits 1."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.commands import prefilter_kmer
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
N_SUBSET = 12


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


def entries_by_key(path):
    with DBReader(str(path)) as r:
        return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def subset_db(tmp_path, keys, name="qsub"):
    """The golden query DB (sequences and headers) restricted to `keys`."""
    out = str(tmp_path / name)
    for suffix in ("", "_h"):
        with DBReader(str(GOLDEN / "qdb") + suffix) as r, \
                DBWriter(out + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    return out


def toy_records():
    return (GOLDEN / "QUERY.fasta").read_text().split(">")[1:]


def test_kmer_prefilter_self_parity(tmp_path, on_cpu):
    """Self-search (sameDB): identity hits injected with USHRT_MAX score."""
    keys = list(range(N_SUBSET))
    sub = subset_db(tmp_path, keys)
    prefilter_kmer.reset_stats()
    run(["prefilter", sub, sub, tmp_path / "prefself"])
    got = entries_by_key(tmp_path / "prefself")
    want = entries_by_key(GOLDEN / "prefself")
    for k in keys:
        assert got[k] == want[k], f"query {k}:\n{got[k]!r}\n!=\n{want[k]!r}"
    st = prefilter_kmer.STATS
    assert st["queries"] == N_SUBSET and st["flushes"] >= 1
    assert st["hits"] == sum(v.count(b"\n") for v in got.values())


@pytest.mark.slow
def test_kmer_prefilter_parity(tmp_path, on_cpu):
    """12 queries (distinct query DB) vs the full 500-sequence target DB at
    the default sensitivity, against the golden `prefsub`."""
    keys = list(range(N_SUBSET))
    sub = subset_db(tmp_path, keys)
    run(["prefilter", sub, GOLDEN / "qdb", tmp_path / "pref"])
    got = entries_by_key(tmp_path / "pref")
    want = entries_by_key(GOLDEN / "prefsub")
    for k in keys:
        assert got[k] == want[k], f"query {k}:\n{got[k]!r}\n!=\n{want[k]!r}"


def test_prefilter_without_diagonal_scoring_runs_the_host_matcher(
        tmp_path, on_cpu):
    sub = subset_db(tmp_path, range(4))
    prefilter_kmer.reset_stats()
    run(["prefilter", sub, sub, tmp_path / "pref", "--diag-score", "0"])
    assert prefilter_kmer.STATS["flushes"] == 0      # no device flush
    got = entries_by_key(tmp_path / "pref")
    for k in range(4):
        assert got[k].split(b"\t")[0] == str(k).encode()


@pytest.mark.parametrize("extra", [
    ["--diag-score", "0"],
    ["--diag-score", "0", "-s", "1", "--comp-bias-corr", "0",
     "--min-ungapped-score", "0", "--max-seqs", "20"],
], ids=["default", "cascaded-step-0"])
def test_host_matcher_matches_the_jax_package(tmp_path, on_cpu, extra):
    """--diag-score 0 (the cascaded clustering's first round) runs the host
    matcher, which enumerates a query's windows in one batch: its entries
    equal the JAX package's prefilter on the same inputs."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    sub = subset_db(tmp_path, range(N_SUBSET))
    prefilter_kmer.reset_stats()
    run(["prefilter", sub, GOLDEN / "qdb", tmp_path / "port", *extra])
    assert prefilter_kmer.STATS["flushes"] == 0
    cmd = get_command("prefilter")
    par = Params().parse([sub, str(GOLDEN / "qdb"), str(tmp_path / "jax"),
                          *extra], cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    got = entries_by_key(tmp_path / "port")
    assert got == entries_by_key(tmp_path / "jax")
    assert sum(v.count(b"\n") for v in got.values()) > N_SUBSET


def test_convertalis_parity(tmp_path, on_cpu):
    out = tmp_path / "aln.m8"
    run(["convertalis", GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "aln", out])
    assert out.read_text() == (GOLDEN / "aln.m8").read_text()


def test_convertalis_sam_matches_the_jax_package(tmp_path, on_cpu):
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    args = [str(GOLDEN / "qdb"), str(GOLDEN / "qdb"), str(GOLDEN / "aln")]
    run(["convertalis", *args, tmp_path / "port.sam", "--format-mode", "1"])
    cmd = get_command("convertalis")
    par = Params().parse([*args, str(tmp_path / "jax.sam"), "--format-mode",
                          "1"], cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    assert (tmp_path / "port.sam").read_text() == \
        (tmp_path / "jax.sam").read_text()


def test_easy_search_matches_golden_lines(tmp_path, on_cpu):
    """easy-search of the first toy queries against the whole toy set: each
    query's lines equal the golden self-search's lines for that query (a
    query's result depends on the target DB only; the identity hit is found
    through the key lookup in both, since the FASTA headers agree)."""
    n = 8
    records = toy_records()
    (tmp_path / "q.fasta").write_text("".join(">" + r for r in records[:n]))
    out = tmp_path / "out.m8"
    run(["easy-search", tmp_path / "q.fasta", GOLDEN / "QUERY.fasta", out,
         tmp_path / "tmp"])
    got = sorted(out.read_text().splitlines())
    names = {line.split("\t")[0] for line in got}
    assert len(names) == n
    want = sorted(line for line in
                  (GOLDEN / "golden_self.m8").read_text().splitlines()
                  if line.split("\t")[0] in names)
    assert got == want
    assert not (tmp_path / "tmp").exists()      # --remove-tmp-files default


def test_search_sensitivity_steps_merge(tmp_path, on_cpu):
    """blastp.sh's stepped search: queries without a hit at the low
    sensitivity go on to the next step; the merged DB holds each query's
    entry from the step that matched it."""
    qsub = subset_db(tmp_path, range(N_SUBSET))
    tsub = subset_db(tmp_path, range(100, 500), "tsub")
    tmp = tmp_path / "tmp"
    run(["search", qsub, tsub, tmp_path / "aln", tmp, "--start-sens", "1",
         "--sens-steps", "2", "-s", "5.7", "--remove-tmp-files", "0"])
    merged = entries_by_key(tmp_path / "aln")
    step0, step1 = entries_by_key(tmp / "aln_0"), entries_by_key(tmp / "aln_1")
    assert sorted(merged) == list(range(N_SUBSET))
    assert set(step1) == {k for k, v in step0.items() if not v}
    assert step1 and len(step1) < N_SUBSET
    for k in merged:
        assert merged[k] == step0[k] + step1.get(k, b"")
    # one step at the target sensitivity equals the JAX package's goldens'
    # way of calling it: prefilter -s 5.7, then align
    run(["search", qsub, tsub, tmp_path / "aln1", tmp_path / "tmp1"])
    single = entries_by_key(tmp_path / "aln1")
    for k, v in step1.items():
        assert single[k] == v


@pytest.mark.parametrize("mode", ["1", "2"])
def test_search_prefilter_mode_runs_ungappedprefilter(tmp_path, on_cpu,
                                                      mode):
    """search --prefilter-mode 1 and 2 put the exhaustive ungapped
    prefilter in the k-mer prefilter's place, as the JAX package's search
    does: the prefilter DB and the alignment DB equal the JAX search's on a
    toy subset."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    qsub = subset_db(tmp_path, range(3))
    tsub = subset_db(tmp_path, range(30), "tsub")
    extra = ["--prefilter-mode", mode, "--remove-tmp-files", "0"]
    run(["search", qsub, tsub, tmp_path / "aln", tmp_path / "tmp", *extra])
    cmd = get_command("search")
    par = Params().parse([qsub, tsub, str(tmp_path / "jaln"),
                          str(tmp_path / "jtmp"), *extra], cmd, cmd.min_db,
                         cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    pref = entries_by_key(tmp_path / "tmp" / "pref_0")
    assert pref == entries_by_key(tmp_path / "jtmp" / "pref_0")
    assert all(pref.values())
    got = entries_by_key(tmp_path / "aln")
    assert got == entries_by_key(tmp_path / "jaln")
    assert sorted(got) == [0, 1, 2] and all(got.values())


def test_search_alignment_mode_4_runs_rescorediagonal(tmp_path, on_cpu):
    """search --alignment-mode 4 puts `rescorediagonal --rescore-mode 2` in
    align's place, as the JAX package's search does: the alignment DB equals
    the JAX search's on a toy subset."""
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    qsub = subset_db(tmp_path, range(4))
    tsub = subset_db(tmp_path, range(40), "tsub")
    extra = ["--alignment-mode", "4"]
    run(["search", qsub, tsub, tmp_path / "aln", tmp_path / "tmp", *extra])
    cmd = get_command("search")
    par = Params().parse([qsub, tsub, str(tmp_path / "jaln"),
                          str(tmp_path / "jtmp"), *extra], cmd, cmd.min_db,
                         cmd.max_db)
    assert cmd.load()(par, cmd) == 0
    got = entries_by_key(tmp_path / "aln")
    assert got == entries_by_key(tmp_path / "jaln")
    assert sorted(got) == [0, 1, 2, 3] and all(got.values())
    # rescore-mode 2 writes alignment records (ten columns), not hit lines
    assert all(len(line.split(b"\t")) == 10
               for v in got.values() for line in v.splitlines())


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
golden, tmp = sys.argv[1], sys.argv[2]
records = open(golden + "/QUERY.fasta").read().split(">")[1:]
with open(tmp + "/q.fasta", "w") as f:
    f.write("".join(">" + r for r in records[:3]))
with open(tmp + "/t.fasta", "w") as f:
    f.write("".join(">" + r for r in records[:60]))
assert main(["easy-search", tmp + "/q.fasta", tmp + "/t.fasta",
             tmp + "/out.m8", tmp + "/tmp"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_easy_search_loads_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, str(GOLDEN),
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert len((tmp_path / "out.m8").read_text().splitlines()) >= 3


NUCL = REPO / "tests" / "golden" / "nucl" / "ndb"
PROFILE = GOLDEN / "it_profile_0"
QDB = GOLDEN / "qdb"

UNPORTED = {
    "search --prefilter-mode 3": ["search", QDB, QDB, "{out}", "{tmp}",
                                  "--prefilter-mode", "3"],
    "ungappedprefilter profile query": ["ungappedprefilter", PROFILE, QDB,
                                        "{out}"],
    "gappedprefilter profile target": ["gappedprefilter", QDB, PROFILE,
                                       "{out}"],
    "convertalis html": ["convertalis", QDB, QDB, GOLDEN / "aln", "{out}",
                         "--format-mode", "3"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_branch_says_so(tmp_path, on_cpu, name):
    args = [str(a).format(out=tmp_path / "out", tmp=tmp_path / "tmp")
            for a in UNPORTED[name]]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(args)
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "out.dbtype").exists()


def nucl_subset(tmp_path, keys, name):
    """The golden nucleotide DB (sequences and headers) restricted to
    `keys`."""
    out = str(tmp_path / name)
    for suffix in ("", "_h"):
        with DBReader(str(NUCL) + suffix) as r, \
                DBWriter(out + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    return out


def run_jax(name, args):
    from mmseqs2_tpu.params import Params
    from mmseqs2_tpu.registry import get_command
    cmd = get_command(name)
    par = Params().parse([str(a) for a in args], cmd, cmd.min_db, cmd.max_db)
    assert cmd.load()(par, cmd) == 0


def _served(monkeypatch, module, server):
    """`query_server` of a client module answered by `server` in this
    process (no socket): both packages' clients import it at call time."""
    monkeypatch.setattr(module, "query_server",
                        lambda db, profile, cap, mode, go=11, ge=1, **kw:
                        server.scan(profile, cap, mode, go, ge))


WIDE = ["--min-ungapped-score", "-1", "-e", "1e30"]


def _nucl_ungapped(tmp_path, monkeypatch):
    q = nucl_subset(tmp_path, [0, 5, 9], "nq3")
    return [["ungappedprefilter", q, NUCL, "{out}"]]


def _nucl_gapped(tmp_path, monkeypatch):
    t = nucl_subset(tmp_path, range(8), "nt8")
    return [["gappedprefilter", subset_db(tmp_path, [0, 1], "q2"), t,
             "{out}", *WIDE]]


def _nucl_padded(tmp_path, monkeypatch):
    return [["makepaddedseqdb", NUCL, "{out}"]]


def _nucl_server(tmp_path, monkeypatch):
    """A server of either package on a padded nucleotide DB, as `gpuserver`
    builds it (the nucleotide matrix at bit factor 1), answering each
    package's `--gpu 1` client."""
    from mmseqs2_tpu.commands.common import get_sub_mat as jax_sub_mat
    from mmseqs2_tpu.params import Params as JaxParams
    from mmseqs2_tpu.server import device_server as jax_server
    from mmseqs2_tpu_torch.params import Params
    from mmseqs2_tpu_torch.server import device_server
    pad = str(tmp_path / "npad")
    run(["makepaddedseqdb", nucl_subset(tmp_path, range(8), "nt8"), pad])
    mine = device_server.DeviceIndexServer(
        pad, device_server.server_submat(Params(), pad), device="cpu")
    theirs = jax_server.DeviceIndexServer(
        pad, jax_sub_mat(JaxParams(), nucl=True, bit_factor=1.0))
    _served(monkeypatch, device_server, mine)
    _served(monkeypatch, jax_server, theirs)
    q = nucl_subset(tmp_path, [0, 5], "nq2")
    return [["ungappedprefilter", q, pad, "{out}", "--gpu", "1", *WIDE],
            ["gappedprefilter", q, pad, "{out}_g", "--gpu", "1", *WIDE]]


NUCL_BRANCHES = {
    "ungappedprefilter nucleotide": _nucl_ungapped,
    "gappedprefilter nucleotide target": _nucl_gapped,
    "makepaddedseqdb nucleotide": _nucl_padded,
    "gpuserver nucleotide": _nucl_server,
}


@pytest.mark.parametrize("name", sorted(NUCL_BRANCHES))
def test_nucleotide_branch_matches_the_jax_package(tmp_path, on_cpu,
                                                   monkeypatch, name):
    """The exhaustive prefilter's, makepaddedseqdb's and gpuserver's
    nucleotide branches give the JAX package's bytes (the amino-acid matrix
    and gap costs locally, the nucleotide matrix in a server: ROADMAP.md
    C)."""
    steps = NUCL_BRANCHES[name](tmp_path, monkeypatch)
    for side, runner in (("port", run), ("jax", lambda a: run_jax(a[0],
                                                                   a[1:]))):
        for step in steps:
            runner([str(a).format(out=tmp_path / side) for a in step])
    outs = [""] + (["_g"] if len(steps) > 1 else [])
    for suffix in outs:
        got = entries_by_key(f"{tmp_path / 'port'}{suffix}")
        want = entries_by_key(f"{tmp_path / 'jax'}{suffix}")
        assert got == want and any(got.values()), suffix
    if name == "makepaddedseqdb nucleotide":
        for suf in ("", ".index", ".dbtype", "_h", "_h.index"):
            assert (pathlib.Path(f"{tmp_path / 'port'}{suf}").read_bytes()
                    == pathlib.Path(f"{tmp_path / 'jax'}{suf}")
                    .read_bytes()), suf


def test_unported_branch_exits_1(tmp_path):
    """From the shell an unported branch ends with exit code 1 and the
    words "not yet ported", and runs nothing else instead."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "mmseqs2_tpu_torch", "search", str(QDB),
         str(QDB), str(tmp_path / "aln"), str(tmp_path / "stmp"),
         "--prefilter-mode", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "not yet ported (see ROADMAP.md)" in r.stderr
    assert not (tmp_path / "aln.dbtype").exists()
    r = subprocess.run(
        [sys.executable, "-m", "mmseqs2_tpu_torch", "rbh", "a", "b", "c",
         "d"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and "not yet ported" in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "mmseqs2_tpu_torch", "linclust", str(QDB),
         str(tmp_path / "clu"), str(tmp_path / "tmp"),
         "--switch-consensus-rep", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "not yet ported (see ROADMAP.md)" in r.stderr
    assert not (tmp_path / "tmp").exists()


def test_score_table_cache_is_the_ports_own(tmp_path, monkeypatch):
    """The port's k-mer score tables are cached under a directory named
    after the port, never under the JAX package's."""
    import numpy as np
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.prefilter.kmer_generator import SubKmerScores
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.delenv("MMSEQS2_TPU_TORCH_CACHE", raising=False)
    seed = get_submat("VTML80.out", 8.0, -0.2)
    two = SubKmerScores(seed.sub_matrix, 20, 2).attach_disk_cache()
    files = sorted(p.name for p in
                   (tmp_path / "cache" / "mmseqs2_tpu_torch").iterdir())
    assert len(files) == 3 and all(f.startswith("subk2_") for f in files)
    again = SubKmerScores(seed.sub_matrix, 20, 2).attach_disk_cache()
    assert np.array_equal(np.asarray(again._scores), np.asarray(two._scores))
    monkeypatch.setenv("MMSEQS2_TPU_TORCH_CACHE", "off")
    SubKmerScores(seed.sub_matrix, 20, 2).attach_disk_cache()
    assert len(list((tmp_path / "cache" / "mmseqs2_tpu_torch").iterdir())) == 3


def test_batched_generator_matches_the_jax_per_window_generator():
    """The port enumerates a query's similar k-mers for all windows in one
    batch (KmerGenerator.generate_all, which the host matcher and the
    device stage-0 both use); window by window it equals the JAX package's
    per-window enumeration (the reference's generateKmerList order), at
    low and high thresholds and over windows of repeated letters."""
    import numpy as np
    from mmseqs2_tpu.prefilter import kmer_generator as jkg
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.prefilter import kmer_generator as kg
    seed = get_submat("VTML80.out", 8.0, -0.2)
    alpha = seed.alphabet_size - 1
    rng = np.random.default_rng(11)
    for k in (6, 7):
        tables = [kg.SubKmerScores(seed.sub_matrix, alpha, n) for n in (3, 2)]
        jtables = [jkg.SubKmerScores(seed.sub_matrix, alpha, n)
                   for n in (3, 2)]
        gen = kg.KmerGenerator(k, alpha, *tables)
        jgen = jkg.KmerGenerator(k, alpha, *jtables)
        windows = rng.integers(0, alpha, size=(16, k)).astype(np.int64)
        windows[:3] = rng.integers(0, alpha, size=(3, 1))   # one letter
        thr = rng.integers(70, 150, size=16).astype(np.int64)
        codes, win_of = gen.generate_all(windows, thr)
        assert len(codes) > 1000 and len(set(win_of.tolist())) > 8
        for w in range(len(windows)):
            want = np.asarray(jgen.generate(windows[w], int(thr[w])))
            assert np.array_equal(codes[win_of == w], want), (k, w)
