"""The posting expansion (B6, mmseqs2_tpu_torch/ops/expand.py) and the
candidate stage that runs it (prefilter/device_stages.stage_candidates)
against the JAX package: posting_expand_plain against the JAX seg_expand
and the gathers of stage_candidates on random CSR triples (zero-count
triples, lists at both ends of the entries, pad triples), and the port's
stage_candidates against the JAX stage_candidates, unpacked (nt=None) and
packed (nt), on the same inputs; and a numpy model of the kernel's
schedule (tiles, their triples' ranges and batches, the marks and the
max-scan) against the plain version at its edges. Every value is an
integer: tolerance 0.
The kernel itself is held against the plain version on the card (`cuda`
cases, skipped without one)."""

import functools

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch.ops import expand
from mmseqs2_tpu_torch.prefilter import device_stages as tds

I64_MAX = np.iinfo(np.int64).max


@functools.lru_cache(maxsize=None)
def jax_modules():
    """jax.numpy, the JAX package's device_stages and its stage_candidates
    compiled once: imported inside the CPU tests, so that the `cuda` cases
    run on a machine without JAX."""
    import jax
    import jax.numpy as jnp
    from mmseqs2_tpu.prefilter import device_stages as jds
    return jnp, jds, jax.jit(jds.stage_candidates,
                             static_argnames=("h_cap", "c_cap", "nt"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_csr(seed, k=300, n_entries=6000, n_q=5, n_t=400, n_pad=17,
             max_count=40):
    """Random CSR triples against random index entries: about a fifth of
    the triples empty, one list at the first entry and one ending at the
    last, positions over the whole u16 range, and n_pad pad triples at the
    end (count 0, start 0, the last query) as the JAX package pads."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count, size=k)
    counts[rng.random(k) < 0.2] = 0
    starts = rng.integers(0, n_entries - counts + 1)
    if k > 3:
        starts[3], counts[3] = 0, 25
        starts[k // 2], counts[k // 2] = n_entries - 31, 31
    qid = np.sort(rng.integers(0, n_q, size=k))
    qpos = rng.integers(0, 3000, size=k)
    pad = np.zeros(n_pad, np.int64)
    return dict(
        starts=np.concatenate([starts, pad]).astype(np.int64),
        counts=np.concatenate([counts, pad]).astype(np.int32),
        qpos=np.concatenate([qpos, pad]).astype(np.int32),
        qid=np.concatenate([qid, pad + n_q - 1]).astype(np.int32),
        entries_seq=rng.integers(0, n_t, size=n_entries).astype(np.int32),
        entries_pos=rng.integers(0, 1 << 16, size=n_entries).astype(
            np.uint16))


def jax_expansion(c, cap):
    """(key, diag) of the JAX seg_expand and stage_candidates' gathers:
    qid << 32 | id and the u16 diagonal per expansion, pad slots INT64_MAX
    and 0."""
    jnp, jds, _ = jax_modules()
    counts = jnp.asarray(c["counts"])
    cum = jds.fast_cumsum(counts)
    trip, within, valid, _ = jds.seg_expand(counts, cum, cap)
    ent = jnp.where(valid, jnp.asarray(c["starts"].astype(np.int32))[trip]
                    + within, 0)
    ids = np.asarray(jnp.asarray(c["entries_seq"])[ent]).astype(np.int64)
    tpos = jnp.asarray(c["entries_pos"])[ent].astype(jnp.int32)
    diag = np.asarray((jnp.asarray(c["qpos"])[trip] - tpos) & 0xFFFF)
    hqid = np.asarray(jnp.asarray(c["qid"])[trip]).astype(np.int64)
    valid = np.asarray(valid)
    key = np.where(valid, (hqid << 32) | ids, I64_MAX)
    return key, np.where(valid, diag, 0).astype(np.uint16)


def port_args(c, device="cpu"):
    """posting_expand's tensors of a make_csr case."""
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()
         if k != "entries_pos"}
    t["entries_pos"] = torch.from_numpy(
        c["entries_pos"].view(np.int16)).to(device)
    cum = torch.cumsum(t["counts"], 0, dtype=torch.int64)
    total = cum[-1] if cum.numel() else cum.new_zeros(())
    return (t["starts"], t["counts"], t["qpos"], t["qid"], cum,
            t["entries_seq"], t["entries_pos"], total)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("extra", [0, 333])
def test_plain_matches_jax_expansion(seed, extra):
    c = make_csr(seed)
    total = int(c["counts"].sum())
    key, diag = expand.posting_expand_plain(*port_args(c), total + extra)
    want_key, want_diag = jax_expansion(c, total + extra)
    assert np.array_equal(key.numpy(), want_key)
    assert np.array_equal(diag.numpy().view(np.uint16), want_diag)
    assert (key.numpy()[total:] == I64_MAX).all()
    # the wrapper on CPU tensors is the plain version
    got = expand.posting_expand(*port_args(c), total + extra)
    assert torch.equal(got[0], key) and torch.equal(got[1], diag)


def test_expansion_edges():
    """No triples, only empty triples, and a capacity below the total:
    every slot is a pad, or the expansions past the capacity are dropped
    (as the JAX seg_expand drops them)."""
    c = make_csr(4, k=0, n_pad=0)
    key, diag = expand.posting_expand(*port_args(c), 8)
    assert (key == expand.KEY_PAD).all() and not diag.any()
    c = make_csr(5, k=20, n_pad=3)
    c["counts"][:] = 0
    key, _ = expand.posting_expand(*port_args(c), 4)
    assert (key == expand.KEY_PAD).all()
    c = make_csr(6)
    total = int(c["counts"].sum())
    key, diag = expand.posting_expand(*port_args(c), total // 3)
    want_key, want_diag = jax_expansion(c, total // 3)
    assert np.array_equal(key.numpy(), want_key)
    assert np.array_equal(diag.numpy().view(np.uint16), want_diag)


def test_contract_breaches_raise():
    args = list(port_args(make_csr(7)))
    bad = list(args)
    bad[0] = args[0].to(torch.int32)
    with pytest.raises(TypeError, match="starts"):
        expand.posting_expand(*bad, 10)
    bad = list(args)
    bad[3] = args[3][:-1].contiguous()
    with pytest.raises(ValueError, match="qid"):
        expand.posting_expand(*bad, 10)
    bad = list(args)
    bad[6] = args[6][:-1].contiguous()
    with pytest.raises(ValueError, match="one value per entry"):
        expand.posting_expand(*bad, 10)
    with pytest.raises(ValueError, match="cap"):
        expand.posting_expand(*args, -1)
    bad = list(args)
    bad[7] = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="total"):
        expand.posting_expand(*bad, 10)


def sorted_ids_case(seed):
    """make_csr with every posting list's ids ascending, as an index's are,
    and ids repeating inside a list, so that double diagonals occur."""
    c = make_csr(seed, n_t=60, max_count=60)
    rng = np.random.default_rng(seed + 50)
    c["entries_seq"] = np.sort(c["entries_seq"])
    c["entries_pos"] = rng.integers(0, 40, size=len(c["entries_pos"])
                                    ).astype(np.uint16)
    c["qpos"] = rng.integers(0, 40, size=len(c["qpos"])).astype(np.int32)
    return c


@pytest.mark.parametrize("seed", [11, 12])
def test_stage_candidates_matches_jax(seed):
    """The port's stage_candidates (the expansion, the int64-key sort, the
    double-diagonal detection, the compaction) against the JAX
    stage_candidates on the same triples, with nt=None (its two-key sort)
    and with nt (its packed key)."""
    jnp, _, jax_stage_candidates = jax_modules()
    c = sorted_ids_case(seed)
    total = int(c["counts"].sum())
    h_cap = 1 << 14               # one compiled JAX program for both seeds
    assert total < h_cap
    t = port_args(c)
    got = tds.stage_candidates(t[0], t[1], t[2], t[3], t[5], t[6],
                               h_cap=h_cap, c_cap=h_cap)
    j_in = [jnp.asarray(c[k].astype(np.int32) if k == "starts" else c[k])
            for k in ("starts", "counts", "qpos", "qid", "entries_seq",
                      "entries_pos")]
    for nt in (None, 60):
        want = jax_stage_candidates(*j_in, h_cap=h_cap, c_cap=h_cap, nt=nt)
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64)), (nt, i)
    assert int(got[4]) > 20 and int(got[5]) == total


def test_packed_and_int64_keys_share_the_scan():
    """sort_dup_packed on the i32 shift-packed key and on the int64 key of
    the same expansions gives the same candidates."""
    c = sorted_ids_case(13)
    total = int(c["counts"].sum())
    key, diag = expand.posting_expand(*port_args(c), total + 50)
    d = diag.to(torch.int32) & 0xFFFF
    valid = key != expand.KEY_PAD
    packed = torch.where(valid, ((key >> 32) << 6) | (key & 0xFFFFFFFF),
                         tds.I32_MAX).to(torch.int32)
    a = tds.sort_dup_packed(key, d, 32)
    b = tds.sort_dup_packed(packed, d, 6)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert int(a[5].sum()) > 20


# -- a model of the kernel's schedule -------------------------------------------

# csrc/expand.cu: threads a block, expansions a thread (THREADS apart),
# triples a batch, tiles whose ranges a block finds together
THREADS, ITEMS, TILE_T, AHEAD = 256, 4, 1024, 4
TILE = THREADS * ITEMS


def test_the_model_has_the_kernels_design():
    from mmseqs2_tpu_torch import PACKAGE_DIR
    text = (PACKAGE_DIR / "csrc" / "expand.cu").read_text()
    assert f"constexpr int THREADS = {THREADS};" in text
    assert f"constexpr int ITEMS = {ITEMS};" in text
    assert f"constexpr int TILE_T = {TILE_T};" in text
    assert "constexpr int AHEAD = NWARPS / 2;" in text and THREADS // 64 == \
        AHEAD
    # after the scan, thread tid expands positions i THREADS + tid
    assert "const long long e = tile + (long long)i * THREADS + tid;" in text
    assert "const int t = s.owner[i * THREADS + tid];" in text


def model_expand(c, cap, grid):
    """posting_expand_kernel's schedule on `grid` blocks: tiles of TILE
    consecutive expansions by a grid-stride loop; every AHEAD tiles a block
    finds the first and last triple of its next AHEAD tiles (the first t
    with cum[t] > e, for the tile's first and last expansion); a tile's
    triples come in batches of at most TILE_T; each triple with a count
    marks its first expansion in the batch (a list begun before it marks
    the batch's first) and a max-scan over the tile, four consecutive
    positions a thread, gives every position its triple, written back to
    the tile's table; thread tid then expands positions i THREADS + tid:
    the entry is starts + e - the running sum before the triple. Returns
    (key, diag as u16) and counts of what the tiles met."""
    starts, counts, qpos, qid = (c[k].astype(np.int64) for k in
                                 ("starts", "counts", "qpos", "qid"))
    seq = c["entries_seq"].astype(np.int64) & 0xFFFFFFFF
    pos = c["entries_pos"].astype(np.int64)
    cum = np.cumsum(counts)
    total = min(int(cum[-1]) if len(cum) else 0, cap)
    key = np.full(cap, -1, np.int64)
    diag = np.full(cap, -1, np.int64)
    seen = dict(tiles=0, batches=0, empty_batches=0, begun_before=0,
                list_past_tile=0, pad_tiles=0)
    for blk in range(grid):
        tiles = list(range(blk * TILE, cap, grid * TILE))
        for i, tile in enumerate(tiles):
            if i % AHEAD == 0:
                ranges = {}
                for j in range(AHEAD):
                    lo = tile + j * grid * TILE
                    hi = min(lo + TILE, cap, total)
                    if lo < hi:
                        ranges[j] = [int(np.searchsorted(cum, e, "right"))
                                     for e in (lo, hi - 1)]
            end = min(tile + TILE, cap)
            real = min(end, total)
            key[max(real, tile):end] = I64_MAX
            diag[max(real, tile):end] = 0
            seen["tiles"] += 1
            if real <= tile:
                seen["pad_tiles"] += 1
                continue
            tb, t_last = ranges[i % AHEAD]
            eb = tile
            while eb < real:
                nt = min(t_last + 1 - tb, TILE_T)
                bc = cum[tb:tb + nt]
                first = np.concatenate([[cum[tb - 1] if tb else 0], bc[:-1]])
                be = min(real, int(bc[-1]))
                owner = np.full(TILE, -1)
                for j in range(nt):
                    if bc[j] > first[j] and first[j] < be:
                        owner[max(first[j], eb) - tile] = j
                        seen["begun_before"] += first[j] < eb
                        seen["list_past_tile"] += (first[j] < tile and
                                                   bc[j] > end)
                # the scan: each thread's four positions, then the block
                table = np.maximum.accumulate(owner)
                # thread tid reads position i THREADS + tid of the table
                pos_of = (np.arange(ITEMS)[:, None] * THREADS
                          + np.arange(THREADS)[None, :]).ravel()
                e = tile + pos_of
                e = e[(e >= eb) & (e < be)]
                t = table[e - tile]
                ent = starts[tb + t] + e - first[t]
                key[e] = (qid[tb + t] << 32) | seq[ent]
                diag[e] = (qpos[tb + t] - pos[ent]) & 0xFFFF
                seen["batches"] += 1
                seen["empty_batches"] += be == eb
                eb, tb = be, tb + nt
    assert (key != -1).all() and (diag >= 0).all()
    return key, diag.astype(np.uint16), seen


def edge_csr(kind, seed=40):
    """make_csr's triples for the schedule's edges: a list longer than a
    tile (TILE + 800 entries), a run of 2,500 zero-count triples (a batch
    of only zero-count triples, between lists), or only zero-count
    triples, or none."""
    if kind == "no-triples":
        return make_csr(seed, k=0, n_pad=0)
    c = make_csr(seed, k=2400, n_entries=9000, max_count=6)
    if kind == "long-list":
        c["starts"][100], c["counts"][100] = 50, TILE + 800
    elif kind == "zero-run":
        # 2,500 empty lists of the query at triple 1,000
        at, n = 1000, 2500
        fill = dict(starts=0, counts=0, qpos=0, qid=c["qid"][at])
        for k, v in fill.items():
            c[k] = np.insert(c[k], at, np.full(n, v, c[k].dtype))
    elif kind == "all-zero":
        c["counts"][:] = 0
    return c


EXPAND_EDGES = {
    "long-list": dict(extra=37, grid=3),
    "zero-run": dict(extra=0, grid=2),
    "cap-below-total": dict(extra=None, grid=2),
    "all-zero": dict(extra=100, grid=2),
    "no-triples": dict(extra=64, grid=1),
}


@pytest.mark.parametrize("kind", sorted(EXPAND_EDGES))
def test_expand_model_matches_plain(kind):
    """The tiled schedule's key and diagonal equal the plain version's (and
    through it the JAX package's expansion) at the schedule's edges: a list
    longer than a tile, tiles that begin inside a list, a batch of only
    zero-count triples, a cap below the total, only zero-count triples and
    no triple at all."""
    spec = EXPAND_EDGES[kind]
    c = edge_csr("plain" if kind == "cap-below-total" else kind)
    total = int(c["counts"].sum())
    cap = total // 2 + 3 if spec["extra"] is None else total + spec["extra"]
    key, diag, seen = model_expand(c, cap, spec["grid"])
    pk, pd = expand.posting_expand_plain(*port_args(c), cap)
    assert np.array_equal(key, pk.numpy())
    assert np.array_equal(diag, pd.numpy().view(np.uint16))
    if kind == "long-list":
        assert seen["list_past_tile"] > 0 and seen["begun_before"] > 1
    if kind == "zero-run":
        assert seen["empty_batches"] > 0
    if kind in ("all-zero", "no-triples"):
        assert seen["pad_tiles"] == seen["tiles"] > 0
    if kind == "cap-below-total":
        assert total > cap and seen["batches"] > 0


@pytest.mark.parametrize("kind", ["long-list", "zero-run",
                                  "cap-below-total"])
def test_expand_edges_plain_matches_jax(kind):
    c = edge_csr("plain" if kind == "cap-below-total" else kind)
    total = int(c["counts"].sum())
    cap = total // 2 + 3 if kind == "cap-below-total" else total + 16
    key, diag = expand.posting_expand_plain(*port_args(c), cap)
    want_key, want_diag = jax_expansion(c, cap)
    assert np.array_equal(key.numpy(), want_key)
    assert np.array_equal(diag.numpy().view(np.uint16), want_diag)


# -- the CUDA kernel (needs the card) ------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,extra", [(1, 300, 0), (2, 300, 5000),
                                         (3, 20000, 1), (4, 0, 64)])
def test_kernel_matches_plain(cuda_device, seed, k, extra):
    c = make_csr(seed, k=k, n_pad=0 if k == 0 else 17)
    total = int(c["counts"].sum())
    args = port_args(c, cuda_device)
    before = expand.posting_expand.launches
    got = expand.posting_expand(*args, total + extra)
    want = expand.posting_expand_plain(*args, total + extra)
    torch.cuda.synchronize()
    assert expand.posting_expand.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(EXPAND_EDGES))
def test_kernel_at_the_schedules_edges(cuda_device, kind):
    """The kernel against its plain version at the schedule model's edges:
    a list longer than a tile, a batch of only zero-count triples, a cap
    below the total, only zero-count triples, no triple."""
    spec = EXPAND_EDGES[kind]
    c = edge_csr("plain" if kind == "cap-below-total" else kind)
    total = int(c["counts"].sum())
    cap = total // 2 + 3 if spec["extra"] is None else total + spec["extra"]
    args = port_args(c, cuda_device)
    got = expand.posting_expand(*args, cap)
    want = expand.posting_expand_plain(*args, cap)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_stage_candidates_on_the_card(cuda_device):
    c = sorted_ids_case(14)
    total = int(c["counts"].sum())
    t = port_args(c)
    want = tds.stage_candidates(t[0], t[1], t[2], t[3], t[5], t[6],
                                h_cap=total, c_cap=total)
    t = port_args(c, cuda_device)
    got = tds.stage_candidates(t[0], t[1], t[2], t[3], t[5], t[6],
                               h_cap=total, c_cap=total)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
