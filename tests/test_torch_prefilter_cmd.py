"""The port's exhaustive prefilter path (`ungappedprefilter`,
`gappedprefilter`, `makepaddedseqdb`, `gpuserver`) with the CPU requested:
against the reference MMseqs2 goldens (tests/golden/toy/upref,
tests/golden/dbops/padded*), against the JAX package's commands on a small
sub-DB, and through a resident server started as a subprocess. All outputs
are bytes of result DBs, compared exactly. JAX is imported inside the tests
that compare with it."""

import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch import cli
from mmseqs2_tpu_torch.align import util as autil
from mmseqs2_tpu_torch.commands import prefilter_cmd
from mmseqs2_tpu_torch.db.reader import DBReader
from mmseqs2_tpu_torch.db.writer import DBWriter
from mmseqs2_tpu_torch.device import ENV
from mmseqs2_tpu_torch.server import device_server

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "toy"
PADDED = REPO / "tests" / "golden" / "dbops" / "padded"
PADDED_FILES = ("", ".index", ".dbtype", ".lookup", "_h", "_h.index",
                "_h.dbtype")


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


def subset_db(tmp_path, keys, name):
    """The golden toy DB (sequences and headers) restricted to `keys`."""
    out = str(tmp_path / name)
    for suffix in ("", "_h"):
        with DBReader(str(GOLDEN / "qdb") + suffix) as r, \
                DBWriter(out + suffix, r.base_type, r.extended_type) as w:
            for k in keys:
                w.write(k, r.get_data(r.get_id(k)))
    return out


def test_ungappedprefilter_matches_golden(tmp_path, on_cpu):
    """Two queries against all 500 toy targets equal the reference's
    ungappedprefilter output."""
    keys = [0, 7]
    sub = subset_db(tmp_path, keys, "qsub")
    prefilter_cmd.reset_stats()
    run(["ungappedprefilter", sub, GOLDEN / "qdb", tmp_path / "upref"])
    got = entries_by_key(tmp_path / "upref")
    want = entries_by_key(GOLDEN / "upref")
    for k in keys:
        assert got[k] == want[k], f"query {k}:\n{got[k]!r}\n!=\n{want[k]!r}"
    st = prefilter_cmd.STATS
    assert st["queries"] == 2 and st["readbacks"] == 2
    assert st["launches"] == 0          # the CPU runs the plain versions
    assert st["hits"] == sum(v.count(b"\n") for v in got.values())


# both commands against the JAX package's on 3 queries x 40 targets; on the
# CPU the JAX gapped command runs dp.sw_scan (E from the pre-F H) and the
# port the kernel's semantics (E from the post-F H): the outputs are equal
# on these inputs, cheap gaps included
JAX_CASES = {
    "ungapped default": ("ungappedprefilter", []),
    "ungapped coverage and max-seqs": (
        "ungappedprefilter", ["-c", "0.8", "--cov-mode", "1", "--max-seqs",
                              "5"]),
    "gapped default": ("gappedprefilter", []),
    "gapped loose": ("gappedprefilter", ["-e", "10", "--min-ungapped-score",
                                         "0"]),
    "gapped cheap gaps": ("gappedprefilter", [
        "--gap-open", "5", "--gap-extend", "1", "-e", "100",
        "--min-ungapped-score", "0"]),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_exhaustive_prefilter_matches_the_jax_command(tmp_path, on_cpu, name):
    cmd, extra = JAX_CASES[name]
    q = subset_db(tmp_path, range(3), "q3")
    t = subset_db(tmp_path, range(40), "t40")
    run([cmd, q, t, tmp_path / "port", *extra])
    run_jax(cmd, [q, t, tmp_path / "jax", *extra])
    got, want = entries_by_key(tmp_path / "port"), \
        entries_by_key(tmp_path / "jax")
    assert got == want
    assert any(got.values())


@pytest.mark.parametrize("cmd", ["ungappedprefilter", "gappedprefilter"])
def test_self_search_keeps_the_identity_hit(tmp_path, on_cpu, cmd):
    """Same DB on both sides: a query's own entry is a hit whatever its
    score and E-value (in the gapped mode with scoreIdentical's score)."""
    db = subset_db(tmp_path, range(5), "t5")
    run([cmd, db, db, tmp_path / "port", "-e", "1e-30"])
    run_jax(cmd, [db, db, tmp_path / "jax", "-e", "1e-30"])
    got, want = entries_by_key(tmp_path / "port"), \
        entries_by_key(tmp_path / "jax")
    assert got == want
    for k in range(5):
        assert got[k].split(b"\t")[0] == str(k).encode()


@pytest.mark.parametrize("cov_mode", range(6))
def test_can_be_covered_many_is_the_scalar_rule(cov_mode):
    rng = np.random.default_rng(cov_mode)
    tlens = rng.integers(1, 400, size=200)
    for qlen, thr in ((120, 0.8), (37, 0.5), (300, 0.0)):
        got = prefilter_cmd.can_be_covered_many(thr, cov_mode, qlen, tlens)
        want = [autil.can_be_covered(thr, cov_mode, qlen, t) for t in tlens]
        assert got.tolist() == want


@pytest.mark.parametrize("max_seqs", [0, 7, 64, 1000])
def test_select_hits_orders_as_the_reference_sort(max_seqs):
    """The partition to --max-seqs keeps what the reference's full sort by
    (|score| descending, key ascending) keeps, ties in the score included."""
    from types import SimpleNamespace
    rng = np.random.default_rng(max_seqs)
    n = 300
    keys = rng.permutation(5 * n)[:n].astype(np.int64)
    scores = rng.integers(10, 22, size=n).astype(np.int32)     # many ties
    par = SimpleNamespace(cov_thr=0.0, cov_mode=0, include_identity=False,
                          min_ungapped_score=15, max_seqs=max_seqs)
    got_k, got_s = prefilter_cmd.select_hits(
        par, prefilter_cmd.MODE_GAPLESS, scores, -1, 100, keys,
        np.full(n, 100), False, None, None)
    hits = [(int(k), int(s)) for k, s in zip(keys, scores) if s > 15]
    hits.sort(key=lambda h: (-abs(h[1]), h[0]))
    assert list(zip(got_k.tolist(), got_s.tolist())) == hits[:max_seqs]


def test_makepaddedseqdb_matches_golden(tmp_path, on_cpu):
    out = tmp_path / "padded"
    run(["makepaddedseqdb", GOLDEN / "qdb", out])
    for suf in PADDED_FILES:
        assert (pathlib.Path(str(PADDED) + suf).read_bytes()
                == pathlib.Path(str(out) + suf).read_bytes()), suf


@pytest.mark.parametrize("extra", [[], ["--mask", "0"],
                                   ["--mask-lower-case", "1"]])
def test_makepaddedseqdb_matches_the_jax_command(tmp_path, on_cpu, extra):
    db = subset_db(tmp_path, range(40), "t40")
    run(["makepaddedseqdb", db, tmp_path / "port", *extra])
    run_jax("makepaddedseqdb", [db, tmp_path / "jax", *extra])
    for suf in PADDED_FILES:
        if suf == ".lookup":
            continue        # written only beside a .lookup of the input
        assert ((tmp_path / ("port" + suf)).read_bytes()
                == (tmp_path / ("jax" + suf)).read_bytes()), suf


def two_per_bucket(n_max=200):
    """Two toy targets of each length bucket (keys ascending), the first
    n_max targets looked at."""
    from mmseqs2_tpu_torch.ops.encode import bucket_length
    with DBReader(str(GOLDEN / "qdb")) as r:
        seen, keys = {}, []
        for i in range(min(n_max, r.size)):
            b = bucket_length(r.get_seq_len(i))
            if seen.get(b, 0) < 2:
                seen[b] = seen.get(b, 0) + 1
                keys.append(r.get_db_key(i))
    return sorted(keys)


@pytest.mark.parametrize("cmd,extra", [
    ("ungappedprefilter", ["--max-seqs", "3"]),
    ("gappedprefilter", ["-e", "100", "--max-seqs", "3"]),
    ("gappedprefilter", ["--add-self-matches", "1"])])
def test_chunked_run_equals_the_resident_run(tmp_path, on_cpu, monkeypatch,
                                             cmd, extra):
    """Past the store budget (a budget under two lanes of the shortest
    bucket, so that every bucket is split) the targets go up chunk by chunk
    for each block of queries (two queries a block): the entries equal the
    run that holds the whole DB, --max-seqs cuts and identity hits
    included."""
    keys = two_per_bucket()
    t = subset_db(tmp_path, keys, "t2b")
    q = subset_db(tmp_path, [keys[0], keys[3], keys[-1]], "q3")
    prefilter_cmd.reset_stats()
    run([cmd, q, t, tmp_path / "resident", *extra])
    assert prefilter_cmd.STATS["chunks"] == 1
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    lens, bucket, order = prefilter_cmd.bucket_plan(EncodedDB(
        open_seq_db(t), get_submat("blosum62.out", 2.0, 0.0)))
    budget = 2 * int(bucket.min()) - 1
    runs = prefilter_cmd.chunk_plan(bucket, order, budget)
    for b in set(bucket.tolist()):
        lanes = np.flatnonzero(bucket[order] == b)
        assert len({next(i for i, (lo, hi) in enumerate(runs)
                         if lo <= lane < hi) for lane in lanes}) == len(lanes)
    monkeypatch.setattr(prefilter_cmd, "STORE_BUDGET", budget)
    monkeypatch.setattr(prefilter_cmd, "QUERY_BLOCK", 2)
    prefilter_cmd.reset_stats()
    run([cmd, q, t, tmp_path / "chunked", *extra])
    st = prefilter_cmd.STATS
    assert st["chunks"] == 2 * len(runs) and st["queries"] == 3
    assert st["store_bytes"] == 2 * int(bucket.sum())
    got = entries_by_key(tmp_path / "chunked")
    assert got == entries_by_key(tmp_path / "resident")
    assert all(got.values())


def test_chunk_plan_covers_the_order_within_the_budget():
    rng = np.random.default_rng(0)
    bucket = rng.choice([32, 64, 128, 1024], size=300).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    for budget in (None, 10 ** 9, 4096, 1000, 31):
        runs = prefilter_cmd.chunk_plan(bucket, order, budget)
        assert runs[0][0] == 0 and runs[-1][1] == len(order)
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        for lo, hi in runs:
            assert hi > lo
            assert (budget is None or hi - lo == 1
                    or bucket[order[lo:hi]].sum() <= budget)
        if budget is None or budget >= bucket.sum():
            assert len(runs) == 1
        else:       # greedy: a run and the next lane pass the budget
            for lo, hi in runs[:-1]:
                assert bucket[order[lo:hi + 1]].sum() > budget


@pytest.mark.parametrize("q_len", [50, 64])
def test_target_store_passes_the_real_lengths(monkeypatch, q_len):
    """The store keeps each bucket's real target lengths in lane order and
    hands them, the query's real length (a power of two included) and the
    profile's largest entry to the gapless kernels; a profile that scores
    the pad letter above the pad score gets no target lengths."""
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import gapless as gapless_ops
    from mmseqs2_tpu_torch.ops.encode import make_query_profile
    submat = get_submat("blosum62.out", 2.0, 0.0)
    store = prefilter_cmd.TargetStore(
        EncodedDB(open_seq_db(str(GOLDEN / "qdb")), submat), "cpu")
    assert len(store.blocks) > 2
    lane = 0
    for block, lens, residues in zip(store.blocks, store.block_lens,
                                     store.block_residues):
        n = block.shape[1]
        real = store.lens[lane:lane + n]     # lane order: store.tids
        lane += n
        assert lens.dtype == torch.int32 and lens.device == store.device
        assert lens.tolist() == real.tolist()
        assert (block != prefilter_cmd.PAD_LETTER).sum(0).tolist() == \
            lens.tolist()
        assert residues == int(real.sum())
    assert lane == store.n_targets

    rng = np.random.default_rng(q_len)
    mat = submat.sub_matrix.astype(np.int32)
    profile = make_query_profile(
        rng.integers(0, 20, size=q_len), mat,
        rng.integers(-3, 4, size=q_len).astype(np.int8))
    assert prefilter_cmd.profile_length(profile) == q_len
    calls = []

    def record(fn):
        def wrapper(prof, block, cap, **kw):
            calls.append((fn.__name__, kw))
            return fn(prof, block, cap, **kw)
        return wrapper
    for name in ("gapless", "gapless_score"):
        monkeypatch.setattr(gapless_ops, name,
                            record(getattr(gapless_ops, name)))
    scores = store.scan(profile, 250, prefilter_cmd.MODE_GAPLESS, 11, 1)
    assert store.scan(profile, 250, prefilter_cmd.MODE_GAPLESS, 11, 1,
                      track=False).tolist() == scores.tolist()
    assert [c[0] for c in calls] == \
        ["gapless"] * len(store.blocks) + ["gapless_score"] * len(store.blocks)
    for (_, kw), lens in zip(calls, store.block_lens * 2):
        assert kw["q_len"] == q_len and kw["prof_max"] == profile.max()
        assert kw["t_lens"] is lens
    calls.clear()
    profile[prefilter_cmd.PAD_LETTER, 0] = 1
    store.scan(profile, 250, prefilter_cmd.MODE_GAPLESS, 11, 1)
    assert all(kw["t_lens"] is None for _, kw in calls)


# -- the resident server --------------------------------------------------------

def _wait_for(path, proc, seconds=60):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if os.path.exists(path):
            return
        assert proc.poll() is None, "the server exited early"
        time.sleep(0.1)
    raise AssertionError("the server did not come up")


def test_gpuserver_round_trip(tmp_path, on_cpu):
    """A server on an 8-target padded DB: `--gpu 1` gives the bytes of the
    run without a server in both modes, the JAX package's client gets the
    same scores from it, and shutdown_server ends it. Both packages read a
    padded DB's numeric codes through the ASCII table, so every target
    letter is X and every score 0 (ROADMAP.md C): the thresholds are opened
    so that the compared entries are not empty, and the port's local run
    is held against the JAX command on the same padded DB."""
    sub = subset_db(tmp_path, range(8), "sub")
    pad = str(tmp_path / "pad")
    run(["makepaddedseqdb", sub, pad])
    q = subset_db(tmp_path, range(3), "q3")
    sock = device_server.socket_path_for(pad)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmseqs2_tpu_torch", "gpuserver", pad],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        _wait_for(sock, proc)
        wide = ["--min-ungapped-score", "-1", "-e", "1e30"]
        for cmd in ("ungappedprefilter", "gappedprefilter"):
            prefilter_cmd.reset_stats()
            run([cmd, q, pad, tmp_path / f"{cmd}_srv", "--gpu", "1", *wide])
            assert prefilter_cmd.STATS["server_s"] > 0
            assert prefilter_cmd.STATS["readbacks"] == 0    # no local scan
            run([cmd, q, pad, tmp_path / f"{cmd}_loc", *wide])
            loc = entries_by_key(tmp_path / f"{cmd}_loc")
            assert entries_by_key(tmp_path / f"{cmd}_srv") == loc
            assert all(v.count(b"\n") == 8 for v in loc.values())
        run_jax("ungappedprefilter", [q, pad, tmp_path / "jax_loc", *wide])
        assert entries_by_key(tmp_path / "jax_loc") == \
            entries_by_key(tmp_path / "ungappedprefilter_loc")

        # the JAX package's client against this server
        from mmseqs2_tpu.server.device_server import query_server as jax_query
        rng = np.random.default_rng(0)
        profile = rng.integers(-4, 8, size=(32, 64)).astype(np.int32)
        mine = device_server.query_server(pad, profile, 250, 0, timeout=30)
        theirs = jax_query(pad, profile, 250, 0, timeout=30)
        assert mine.shape == (8,) and np.array_equal(mine, theirs)
        assert mine.max() > 0
        pong = device_server.ping_server(pad, timeout=30)
        assert pong["ok"] and pong["n_targets"] == 8
        assert pong["launches"] == {"gapless_score": 0, "sw_single": 0,
                                    "sw_score": 0}

        # a request the server cannot serve fails the client, not the server
        with pytest.raises(RuntimeError, match="failed a request"):
            device_server.query_server(pad, profile[:7], 250, 0, timeout=30)
        assert device_server.query_server(pad, profile, 250, 1,
                                          timeout=30).shape == (8,)

        assert device_server.shutdown_server(pad, timeout=30)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if os.path.exists(sock):
            os.unlink(sock)


def test_server_scans_run_the_score_only_kernels(tmp_path, on_cpu,
                                                 monkeypatch):
    """A request to the resident server runs the score-only kernel of its
    mode (gapless_score, sw_score; here their plain versions), never the
    end-tracking one, and its scores equal a tracked local scan."""
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import gapless as gapless_ops
    from mmseqs2_tpu_torch.ops import sw as sw_ops
    sub = subset_db(tmp_path, range(8), "sub")
    pad = str(tmp_path / "pad")
    run(["makepaddedseqdb", sub, pad])
    server = device_server.DeviceIndexServer(
        pad, get_submat("blosum62.out", 2.0, 0.0), device="cpu")
    calls = []
    for mod, name in ((gapless_ops, "gapless"), (gapless_ops, "gapless_score"),
                      (sw_ops, "sw_single"), (sw_ops, "sw_score")):
        def wrapper(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    profile = np.random.default_rng(1).integers(
        -4, 8, size=(32, 40)).astype(np.int32)
    for mode, kernel in ((prefilter_cmd.MODE_GAPLESS, "gapless_score"),
                         (prefilter_cmd.MODE_GAPPED, "sw_score")):
        calls.clear()
        got = server.scan(profile, 250, mode)
        assert calls and set(calls) == {kernel}
        local = server.store.in_db_order(
            server.store.scan(profile, 250, mode, 11, 1).numpy())
        assert np.array_equal(got, local) and got.max() > 0


def test_gpu_flag_without_a_server_warns_and_computes_locally(
        tmp_path, on_cpu, capsys):
    q = subset_db(tmp_path, range(2), "q2")
    t = subset_db(tmp_path, range(8), "t8")
    assert device_server.query_server(t, np.zeros((32, 32), np.int32), 250,
                                      0) is None
    assert not device_server.shutdown_server(t)
    run(["ungappedprefilter", q, t, tmp_path / "gpu", "--gpu", "1"])
    assert "no gpuserver running" in capsys.readouterr().err
    run(["ungappedprefilter", q, t, tmp_path / "loc"])
    assert entries_by_key(tmp_path / "gpu") == entries_by_key(tmp_path / "loc")


def test_a_server_that_fails_a_request_fails_the_command(tmp_path, on_cpu):
    """A socket left behind by a server that is gone counts as no server; a
    server that takes the connection and hangs up without an answer raises,
    and so does the command: it does not turn local without a word."""
    q = subset_db(tmp_path, range(2), "q2")
    t = subset_db(tmp_path, range(8), "t8")
    path = device_server.socket_path_for(t)
    profile = np.zeros((32, 32), np.int32)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(4)
        srv.close()                             # stale: nobody listens
        assert device_server.query_server(t, profile, 250, 0) is None
        os.unlink(path)

        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(4)
        srv.settimeout(30)

        def hang_up(n):
            for _ in range(n):
                conn, _ = srv.accept()
                conn.recv(8)
                conn.close()
        th = threading.Thread(target=hang_up, args=(2,), daemon=True)
        th.start()
        with pytest.raises(RuntimeError, match="failed a request"):
            device_server.query_server(t, profile, 250, 0, timeout=10)
        with pytest.raises(RuntimeError, match="failed a request"):
            cli.main(["ungappedprefilter", q, t, str(tmp_path / "out"),
                      "--gpu", "1"])
        th.join(timeout=30)
        assert not (tmp_path / "out.dbtype").exists()
    finally:
        srv.close()
        if os.path.exists(path):
            os.unlink(path)


SUBPROCESS_RUN = """
import sys
from mmseqs2_tpu_torch.cli import main
q, t, out = sys.argv[1:4]
assert main(["ungappedprefilter", q, t, out + "_u"]) == 0
assert main(["gappedprefilter", q, t, out + "_g", "-e", "10"]) == 0
assert main(["makepaddedseqdb", t, out + "_pad"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmseqs2_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_exhaustive_commands_load_no_jax(tmp_path):
    q = subset_db(tmp_path, range(2), "q2")
    t = subset_db(tmp_path, range(8), "t8")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env[ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", SUBPROCESS_RUN, q, t,
                        str(tmp_path / "out")], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert entries_by_key(tmp_path / "out_u")[0]


# -- the kernels through the store (needs the card) -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cmd", ["ungappedprefilter", "gappedprefilter"])
def test_commands_on_the_card_match_the_cpu(tmp_path, monkeypatch, cmd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q = subset_db(tmp_path, range(4), "q4")
    t = subset_db(tmp_path, range(60), "t60")
    monkeypatch.setenv(ENV, "cuda")
    prefilter_cmd.reset_stats()
    run([cmd, q, t, tmp_path / "card", "-e", "10"])
    assert prefilter_cmd.STATS["launches"] > 0
    monkeypatch.setenv(ENV, "cpu")
    run([cmd, q, t, tmp_path / "cpu", "-e", "10"])
    assert entries_by_key(tmp_path / "card") == entries_by_key(tmp_path / "cpu")
