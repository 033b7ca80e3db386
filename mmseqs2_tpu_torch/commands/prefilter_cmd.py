"""Exhaustive prefilter commands: `ungappedprefilter` / `gappedprefilter`.

Port of mmseqs2_tpu/commands/prefilter_cmd.py (reference
src/prefiltering/ungappedprefilter.cpp: CPU path :349-485, GPU path :40-345).
For every query the whole target DB is scored on the device: the gapless
diagonal scan (ops/gapless.py) or the gapped Smith-Waterman scan
(ops/sw.py:sw_single). Hits above --min-ungapped-score (strictly greater)
are kept, sorted by (|score| desc, key asc), truncated to --max-seqs and
written as `targetKey \\t score \\t 0` prefilter records.

What differs from the JAX command, with the same bytes out:
  - the padded target buckets are uploaded as int8 with their real lengths
    (TargetStore, shared with the resident server; both kernels skip the
    pad rows and columns), once for all queries when they fit in the store
    budget (STORE_BUDGET), not once per query as the JAX command uploads
    chunks of (1 << 22) // the longest bucket rows;
  - past the budget the targets, in bucket order, are cut into chunks under
    it; the chunks run outermost and the queries (a block of QUERY_BLOCK at
    a time) inside, so each chunk is uploaded once a block. A query keeps
    at most --max-seqs hits a chunk; every filter is a target's own
    (coverage, score, E-value, identity) and the order is total, so
    merging the chunks' hits and cutting to --max-seqs gives the same
    records;
  - a query's scores come back in one read-back of the chunk's scores; the
    next query's scan is enqueued before the host waits for it;
  - coverage, score threshold, E-value and identity are applied to the whole
    score vector at once; hit records are built for survivors only.

Sequence DBs of either type, as the JAX command takes them: a nucleotide DB
is encoded with the amino-acid matrix and scored with the amino-acid gap
costs there too (its prefilter_cmd.py:59-66). Profile DBs are not yet
ported. The k-mer `prefilter` lives in prefilter_kmer.py.
"""

import time

import numpy as np
import torch

from ..align import util as autil
from ..align.aligner import Aligner, PAD_LETTER
from ..db import dbtype as dbt
from ..db.writer import DBWriter
from ..device import get_device
from ..ops import gapless as gapless_ops
from ..ops import sw as sw_ops
from ..ops.encode import bucket_length
from ..ops.evalue import EvalueComputation
from ..utils import log
from .common import EncodedDB, get_sub_mat, open_seq_db

MODE_GAPLESS = 0
MODE_GAPPED = 1

# bytes of padded targets one upload may hold: None is 80% of the card's
# free memory (no bound on the CPU); past it the targets go in chunks
STORE_BUDGET = None
# queries whose contexts a chunked run keeps while the chunks pass
QUERY_BLOCK = 1024

# Counters of the exhaustive prefilter, summed until reset_stats(): queries,
# hits written, target chunks uploaded (one a run when the targets fit, the
# chunks times the query blocks past the budget), kernel launches and
# read-backs of score vectors, the cells of the local scans' padded buckets
# (padded query rows times padded target columns) and the cells their
# kernels compute (the rows the kernel's strips cover times the targets'
# real columns), seconds to encode, pad and upload the targets (store_s)
# and the bytes uploaded (store_bytes), the scans' device milliseconds (CUDA
# events; 0 on the CPU), seconds the host waited for read-backs (wait_s) or
# for the server's replies (server_s), and seconds of host work per query:
# profile set-up, filter, sort and write (host_s).
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(queries=0, hits=0, chunks=0, launches=0, readbacks=0,
                 cells_padded=0, cells_computed=0, store_s=0.0,
                 store_bytes=0, kernel_ms=0.0, wait_s=0.0, server_s=0.0,
                 host_s=0.0)


reset_stats()


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def profile_length(profile):
    """The real rows of a (32, Lq) query profile: one past the last query
    position with an entry above the pad score -(1 << 20)."""
    real = np.flatnonzero((np.asarray(profile) > gapless_ops.NEG).any(axis=0))
    return int(real[-1]) + 1 if len(real) else 0


def bucket_plan(tdb):
    """Every target's length, its bucket's length, and the targets in
    bucket order (stable), as numpy arrays."""
    lens = np.array([len(tdb.seq_num(i)) for i in range(tdb.size)],
                    dtype=np.int64)
    bucket = np.array([bucket_length(n) for n in lens], dtype=np.int64)
    return lens, bucket, np.argsort(bucket, kind="stable")


def store_budget(device):
    """STORE_BUDGET, or 80% of the card's free memory (None on the CPU)."""
    if STORE_BUDGET is not None:
        return int(STORE_BUDGET)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(0.8 * free)
    return None


def chunk_plan(bucket, order, budget):
    """[lo, hi) runs of `order` whose padded bytes (a lane's bucket length)
    stay within budget, each at least one target; one run when budget is
    None or everything fits."""
    if budget is None or len(order) == 0:
        return [(0, len(order))]
    cum = np.cumsum(bucket[order])
    runs, lo, base = [], 0, 0
    while lo < len(order):
        hi = int(np.searchsorted(cum, base + budget, side="right"))
        hi = max(hi, lo + 1)
        runs.append((lo, hi))
        base = int(cum[hi - 1])
        lo = hi
    return runs


class TargetStore:
    """Targets padded into power-of-two length buckets that stay on the
    device: per bucket one (L, n) int8 tensor, pad letter 31, transposed once
    here so that every scan reads it as it lies, and one (n,) int32 tensor of
    the targets' real lengths in the same lane order, so that the kernels
    skip the pad columns. `tids`: the targets it holds, in bucket order
    (default: all of them; a chunk of a run past the budget holds a run of
    that order); scores come back in the order of `self.tids`. Shared by the
    commands and the resident server."""

    def __init__(self, tdb: EncodedDB, device, tids=None):
        t0 = time.perf_counter()
        self.device = torch.device(device)
        if tids is None:
            _, _, tids = bucket_plan(tdb)
        self.tids = np.asarray(tids, dtype=np.int64)
        seqs = [tdb.seq_num(int(i)) for i in self.tids]
        self.n_targets = len(seqs)
        lens = np.array([len(q) for q in seqs], dtype=np.int64)
        bucket = np.array([bucket_length(n) for n in lens], dtype=np.int64)
        if np.any(np.diff(bucket) < 0):
            raise ValueError("TargetStore: tids must be in bucket order")
        sizes = sorted(set(bucket.tolist()))
        self.nbytes = int(bucket.sum())
        self.blocks, self.block_lens, self.block_residues = [], [], []
        for L in sizes:
            rows = np.flatnonzero(bucket == L)
            tb = np.full((len(rows), L), PAD_LETTER, dtype=np.int8)
            for r, k in enumerate(rows):
                tb[r, :lens[k]] = seqs[k]
            self.blocks.append(torch.from_numpy(
                np.ascontiguousarray(tb.T)).to(self.device))
            blens = lens[rows].astype(np.int32)
            self.block_lens.append(torch.from_numpy(blens).to(self.device))
            self.block_residues.append(int(blens.sum()))
        self.lens = lens
        STATS["chunks"] += 1
        STATS["store_bytes"] += self.nbytes
        STATS["store_s"] += time.perf_counter() - t0

    def scan(self, profile, cap, mode, go, ge, track=True):
        """Scores of one (32, Lq) int32 profile against every target: a
        (n_targets,) int32 device tensor in bucket order (see in_db_order).
        With track the end-tracking kernel runs (gapless, sw_single),
        without it the score-only one (gapless_score, sw_score); both give
        the same scores. The kernels get the query's real length (the rows
        up to its last that is not pad) and the profile's largest entry
        from this host copy, and the targets' real lengths where the
        profile scores the pad letter as pad on those rows (a profile built
        by make_query_profile does)."""
        profile = np.ascontiguousarray(profile, dtype=np.int32)
        prof = torch.from_numpy(profile).to(self.device)
        q_len = profile_length(profile)
        prof_max = int(profile.max())
        pad_scored_as_pad = bool(
            (profile[PAD_LETTER, :q_len] <= gapless_ops.NEG).all())
        # both kernels share the strip plan of ops/gapless.py
        if mode == MODE_GAPPED:
            kernel = sw_ops.sw_single if track else sw_ops.sw_score
            form = sw_ops.pick_form(q_len, prof_max, go, ge)
            args = dict(go=go, ge=ge)
        else:
            kernel = (gapless_ops.gapless if track
                      else gapless_ops.gapless_score)
            form = gapless_ops.pick_form(cap, prof_max)
            args = dict(cap=cap)
        rows = gapless_ops.rows_computed(form, q_len)
        parts = []
        for block, lens, residues in zip(self.blocks, self.block_lens,
                                         self.block_residues):
            t_lens = lens if pad_scored_as_pad else None
            out = kernel(prof, block, q_len=q_len, t_lens=t_lens,
                         prof_max=prof_max, **args)
            parts.append(out[0] if track else out)
            STATS["cells_computed"] += rows * (
                residues if t_lens is not None else block.numel())
        if not parts:
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return torch.cat(parts)

    def in_db_order(self, flat):
        """Host scores of a whole DB's store (self.tids a permutation of
        the DB) -> (n_targets,) in DB order."""
        out = np.empty(self.n_targets, dtype=np.int32)
        out[self.tids] = flat
        return out


def _launch_count():
    return (gapless_ops.gapless.launches + gapless_ops.gapless_score.launches
            + sw_ops.sw_single.launches + sw_ops.sw_score.launches)


class _Scan:
    """One query's scan in flight: its scores go to pinned host memory right
    behind the kernels, and result() waits for that copy alone, so that the
    next query's kernels run while the host filters this one's scores."""

    def __init__(self, store, profile, cap, mode, go, ge):
        self.store = store
        cuda = store.device.type == "cuda"
        before = _launch_count()
        if cuda:
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(3)]
            self.events[0].record()
        flat = store.scan(profile, cap, mode, go, ge)
        if cuda:
            self.events[1].record()
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.events[2].record()
        else:
            self.events = None
            self.host = flat
        STATS["launches"] += _launch_count() - before
        STATS["readbacks"] += 1
        STATS["cells_padded"] += profile.shape[1] * store.nbytes

    def result(self):
        """The scores in the order of the store's tids."""
        if self.events is not None:
            t0 = time.perf_counter()
            self.events[2].synchronize()
            STATS["wait_s"] += time.perf_counter() - t0
            STATS["kernel_ms"] += self.events[0].elapsed_time(self.events[1])
        return self.host.numpy()


def can_be_covered_many(cov_thr, cov_mode, qlen, tlens):
    """align.util.can_be_covered for one query length against an array of
    target lengths, in the same float64 arithmetic."""
    q = float(qlen)
    t = np.asarray(tlens, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if cov_mode == autil.COV_MODE_BIDIRECTIONAL:
            return (q / t >= cov_thr) & (t / q >= cov_thr)
        if cov_mode == autil.COV_MODE_QUERY:
            return t / q >= cov_thr
        if cov_mode == autil.COV_MODE_TARGET:
            return q / t >= cov_thr
        if cov_mode == autil.COV_MODE_LENGTH_QUERY:
            return (cov_thr <= t / q) & (t / q <= 1.0)
        if cov_mode == autil.COV_MODE_LENGTH_TARGET:
            return (cov_thr <= q / t) & (q / t <= 1.0)
        if cov_mode == autil.COV_MODE_LENGTH_SHORTER:
            return np.minimum(q, t) / np.maximum(q, t) >= cov_thr
    return np.ones(t.shape, dtype=bool)


def select_hits(par, mode, scores, query_key, q_len, t_keys, t_lens, same_db,
                identical_score, evaluer):
    """The hits of one query from the scores of the targets t_keys, t_lens
    (the whole DB or a chunk of it, in any order), as (keys, scores) sorted
    by |score| descending, then key, and cut to --max-seqs:
    hit_t::compareHitsByScoreAndId. A target is a hit if its length can be
    covered and it is the query itself (same key, same DB or
    --add-self-matches) or scores above --min-ungapped-score and, in the
    gapped mode, within the E-value threshold. identical_score(i) gives the
    gapped mode's score of the query against its target i."""
    covered = can_be_covered_many(par.cov_thr, par.cov_mode, q_len, t_lens)
    if par.include_identity or same_db:
        ident = covered & (t_keys == query_key)
    else:
        ident = np.zeros(len(scores), dtype=bool)
    above = covered & (scores > par.min_ungapped_score)
    if mode == MODE_GAPPED:
        scores = scores.copy()
        for tid in np.flatnonzero(ident):
            scores[tid] = identical_score(tid)
        # the E-value is a scalar formula: once per distinct score
        idx = np.flatnonzero(above)
        uniq, inverse = np.unique(scores[idx], return_inverse=True)
        ok = np.array([evaluer.compute_evalue(int(s), q_len) <= par.evalue
                       for s in uniq], dtype=bool)
        above = np.zeros(len(scores), dtype=bool)
        above[idx[ok[inverse]]] = True
    sel = np.flatnonzero(ident | above)
    keys, vals = t_keys[sel], scores[sel].astype(np.int64)
    # the order as one int64 (DB keys are below 2^32, |score| at most 2^31):
    # most queries keep nearly every target here, so cut to --max-seqs by
    # a partition and sort only what is written
    return top_hits(keys, vals, par.max_seqs)


def top_hits(keys, vals, max_seqs):
    """(keys, vals) int64 sorted by |score| descending, then key, and cut
    to max_seqs. The order as one int64 (DB keys are below 2^32, |score| at
    most 2^31): most queries keep nearly every target, so the cut is a
    partition and only what is written is sorted."""
    rank = (((1 << 31) - np.abs(vals)) << 32) | keys
    k = max(int(max_seqs), 0)
    top = np.argpartition(rank, k)[:k] if k < len(rank) else \
        np.arange(len(rank))
    order = top[np.argsort(rank[top])]
    return keys[order], vals[order]


def _write_hits(writer, query_key, keys, scores):
    buf = "".join(f"{k}\t{s}\t0\n" for k, s in zip(keys.tolist(),
                                                    scores.tolist()))
    writer.write(query_key, buf.encode())


def prefilter_exhaustive(par, mode):
    """mode 0: gapless (ungappedprefilter); 1: gapped SW (gappedprefilter)."""
    qdb_path, tdb_path, out_path = par.filenames[:3]
    same_db = qdb_path == tdb_path
    submat = get_sub_mat(par)
    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    for reader, side in ((qreader, "query"), (treader, "target")):
        if reader.base_type not in (dbt.DBTYPE_AMINO_ACIDS,
                                    dbt.DBTYPE_NUCLEOTIDES):
            _not_ported(f"the exhaustive prefilter with a profile {side} "
                        f"database")
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    go, ge = par.gap_open.aa, par.gap_extend.aa

    evaluer = EvalueComputation(treader.total_residues(), submat, go, ge)
    aligner = Aligner(submat, go, ge, evaluer, par.comp_bias_corr,
                      par.comp_bias_corr_scale)
    t_keys = np.asarray(treader.keys, dtype=np.int64)
    lens, bucket, order = bucket_plan(tdb)

    def context(qid):
        t0 = time.perf_counter()
        ctx = aligner.init_query(qdb.seq_num(qid))
        STATS["host_s"] += time.perf_counter() - t0
        return ctx

    def select(qid, ctx, scores, tids):
        """The query's hits among the targets tids, whose scores these
        are."""
        t0 = time.perf_counter()
        hits = select_hits(
            par, mode, scores, qreader.get_db_key(qid), len(ctx.q_num),
            t_keys[tids], lens[tids], same_db,
            lambda i: aligner.score_identical(
                ctx, tdb.seq_num(int(tids[i])), 0).raw_score, evaluer)
        STATS["host_s"] += time.perf_counter() - t0
        return hits

    def write(qid, hits):
        t0 = time.perf_counter()
        _write_hits(writer, qreader.get_db_key(qid), *hits)
        STATS["queries"] += 1
        STATS["hits"] += len(hits[0])
        STATS["host_s"] += time.perf_counter() - t0

    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    # --gpu 1: a resident server (gpuserver) scores the whole target DB per
    # request. The first query decides: without a server the scans run here;
    # a server that answered once and then is gone fails the run.
    served = False
    if par.gpu and qdb.size:
        from ..server.device_server import query_server
        all_tids = np.arange(tdb.size)
        for qid in range(qdb.size):
            ctx = context(qid)
            t0 = time.perf_counter()
            scores = query_server(tdb_path, ctx.profile, 255 - ctx.bias,
                                  mode, go, ge)
            STATS["server_s"] += time.perf_counter() - t0
            if scores is None and qid > 0:
                raise RuntimeError("the gpuserver for the target DB went "
                                   "away during the run")
            if scores is None:
                log.warning("no gpuserver running for the target DB; "
                            "computing locally")
                break
            served = True
            write(qid, select(qid, ctx, np.asarray(scores, np.int32),
                              all_tids))
    if not served:
        _scan_local(qdb.size, context, select, write, tdb, bucket, order,
                    mode, go, ge, par.max_seqs)
    writer.close()
    return 0


def _scan_local(n_queries, context, select, write, tdb, bucket, order, mode,
                go, ge, max_seqs):
    """Every query against every target on this process's device. The
    targets that fit the store budget go up once; past it, chunk by chunk
    (chunk_plan) for each block of QUERY_BLOCK queries, each query's hits
    merged over the chunks (top_hits) and written once the block's last
    chunk is done."""
    device = get_device()
    runs = chunk_plan(bucket, order, store_budget(device))
    chunked = len(runs) > 1
    block = QUERY_BLOCK if chunked else max(n_queries, 1)
    for qlo in range(0, n_queries, block):
        qids = range(qlo, min(qlo + block, n_queries))
        ctxs = {qid: context(qid) for qid in qids} if chunked else None
        merged = {}

        def collect(qid, ctx, scan, tids):
            hits = select(qid, ctx, scan.result(), tids)
            if not chunked:
                write(qid, hits)
            elif qid in merged:
                prev = merged[qid]
                merged[qid] = top_hits(np.concatenate([prev[0], hits[0]]),
                                       np.concatenate([prev[1], hits[1]]),
                                       max_seqs)
            else:
                merged[qid] = hits

        for lo, hi in runs:
            tids = order[lo:hi]
            store = TargetStore(tdb, device, tids)
            pending = None
            for qid in qids:
                ctx = ctxs[qid] if chunked else context(qid)
                scan = _Scan(store, ctx.profile, 255 - ctx.bias, mode, go,
                             ge)
                if pending is not None:
                    collect(*pending)
                pending = (qid, ctx, scan, tids)
            if pending is not None:
                collect(*pending)
            store = pending = None
        if chunked:
            for qid in qids:
                write(qid, merged[qid])


def ungappedprefilter(par, command):
    return prefilter_exhaustive(par, MODE_GAPLESS)


def gappedprefilter(par, command):
    return prefilter_exhaustive(par, MODE_GAPPED)
