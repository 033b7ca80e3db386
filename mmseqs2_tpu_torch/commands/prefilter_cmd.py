"""Exhaustive prefilter commands: `ungappedprefilter` / `gappedprefilter`.

Port of mmseqs2_tpu/commands/prefilter_cmd.py (reference
src/prefiltering/ungappedprefilter.cpp: CPU path :349-485, GPU path :40-345).
For every query the whole target DB is scored on the device: the gapless
diagonal scan (ops/gapless.py) or the gapped Smith-Waterman scan
(ops/sw.py:sw_single). Hits above --min-ungapped-score (strictly greater)
are kept, sorted by (|score| desc, key asc), truncated to --max-seqs and
written as `targetKey \\t score \\t 0` prefilter records.

What differs from the JAX command, with the same bytes out:
  - the padded target buckets are uploaded once as int8 with their real
    lengths (TargetStore, shared with the resident server; both kernels
    skip the pad rows and columns), not once per query; there is no chunk
    bound: the buckets of a DB take its residues times at most 2 in bytes, and a DB
    that does not fit in the card's free memory is refused at upload;
  - a query's scores come back in one read-back of (n_targets,) int32; the
    next query's scan is enqueued before the host waits for it;
  - coverage, score threshold, E-value and identity are applied to the whole
    score vector at once; hit records are built for survivors only.

Protein sequence queries and targets; nucleotide and profile DBs are not
yet ported. The k-mer `prefilter` lives in prefilter_kmer.py.
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

# Counters of the exhaustive prefilter, summed until reset_stats(): queries,
# hits written, kernel launches and read-backs of score vectors, the cells
# of the local scans' padded buckets (padded query rows times padded target
# columns) and the cells their kernels compute (the rows the kernel's
# strips cover times the targets' real columns), seconds to encode, pad and upload the targets (store_s) and
# the bytes of the resident buckets, the scans' device milliseconds (CUDA
# events; 0 on the CPU), seconds the host waited for read-backs (wait_s) or
# for the server's replies (server_s), and seconds of host work per query:
# profile set-up, filter, sort and write (host_s).
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(queries=0, hits=0, launches=0, readbacks=0, cells_padded=0,
                 cells_computed=0, store_s=0.0, store_bytes=0, kernel_ms=0.0,
                 wait_s=0.0, server_s=0.0, host_s=0.0)


reset_stats()


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def profile_length(profile):
    """The real rows of a (32, Lq) query profile: one past the last query
    position with an entry above the pad score -(1 << 20)."""
    real = np.flatnonzero((np.asarray(profile) > gapless_ops.NEG).any(axis=0))
    return int(real[-1]) + 1 if len(real) else 0


class TargetStore:
    """A target DB padded into power-of-two length buckets that stay on the
    device: per bucket one (L, n) int8 tensor, pad letter 31, transposed once
    here so that every scan reads it as it lies, and one (n,) int32 tensor of
    the targets' real lengths in the same lane order, so that the kernels
    skip the pad columns. Shared by the commands and the resident
    server."""

    def __init__(self, tdb: EncodedDB, device):
        t0 = time.perf_counter()
        self.device = torch.device(device)
        seqs = [tdb.seq_num(i) for i in range(tdb.size)]
        self.n_targets = len(seqs)
        self.lens = np.array([len(s) for s in seqs], dtype=np.int64)
        bucket = np.array([bucket_length(n) for n in self.lens],
                          dtype=np.int64)
        # targets in bucket order; scores come back in this order
        self.order = np.argsort(bucket, kind="stable")
        sizes = sorted(set(bucket.tolist()))
        nbytes = sum(L * int((bucket == L).sum()) for L in sizes)
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > 0.8 * free:
                raise RuntimeError(
                    f"the padded target DB takes {nbytes} bytes, the card "
                    f"has {free} free; splitting the target DB is not yet "
                    f"ported (see ROADMAP.md)")
        self.blocks, self.block_lens, self.block_residues = [], [], []
        for L in sizes:
            tids = self.order[bucket[self.order] == L]
            tb = np.full((len(tids), L), PAD_LETTER, dtype=np.int8)
            for r, tid in enumerate(tids):
                tb[r, :self.lens[tid]] = seqs[tid]
            self.blocks.append(torch.from_numpy(
                np.ascontiguousarray(tb.T)).to(self.device))
            lens = self.lens[tids].astype(np.int32)
            self.block_lens.append(torch.from_numpy(lens).to(self.device))
            self.block_residues.append(int(lens.sum()))
        self.nbytes = nbytes
        STATS["store_bytes"] += nbytes
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
        """Host scores in bucket order -> (n_targets,) in DB order."""
        out = np.empty(self.n_targets, dtype=np.int32)
        out[self.order] = flat
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
        if self.events is not None:
            t0 = time.perf_counter()
            self.events[2].synchronize()
            STATS["wait_s"] += time.perf_counter() - t0
            STATS["kernel_ms"] += self.events[0].elapsed_time(self.events[1])
        return self.store.in_db_order(self.host.numpy())


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
    """The hits of one query from its whole score vector (DB order), as
    (keys, scores) sorted by |score| descending, then key, and cut to
    --max-seqs: hit_t::compareHitsByScoreAndId. A target is a hit if its
    length can be covered and it is the query itself (same key, same DB or
    --add-self-matches) or scores above --min-ungapped-score and, in the
    gapped mode, within the E-value threshold. identical_score(tid) gives
    the gapped mode's score of the query against itself."""
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
    rank = (((1 << 31) - np.abs(vals)) << 32) | keys
    k = max(int(par.max_seqs), 0)
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
        if reader.base_type != dbt.DBTYPE_AMINO_ACIDS:
            _not_ported(f"the exhaustive prefilter with a nucleotide or "
                        f"profile {side} database")
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    go, ge = par.gap_open.aa, par.gap_extend.aa

    evaluer = EvalueComputation(treader.total_residues(), submat, go, ge)
    aligner = Aligner(submat, go, ge, evaluer, par.comp_bias_corr,
                      par.comp_bias_corr_scale)
    t_keys = np.asarray(treader.keys, dtype=np.int64)

    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    t_lens = None       # target lengths; set with the first query

    def finish(qid, ctx, scores):
        t0 = time.perf_counter()
        query_key = qreader.get_db_key(qid)
        keys, vals = select_hits(
            par, mode, scores, query_key, len(ctx.q_num), t_keys, t_lens,
            same_db, lambda tid: aligner.score_identical(
                ctx, tdb.seq_num(tid), 0).raw_score, evaluer)
        _write_hits(writer, query_key, keys, vals)
        STATS["queries"] += 1
        STATS["hits"] += len(keys)
        STATS["host_s"] += time.perf_counter() - t0

    # --gpu 1: a resident server (gpuserver) scores the whole target DB per
    # request. The first query decides: without a server the scans run here;
    # a server that answered once and then is gone fails the run.
    use_server = bool(par.gpu)
    store = pending = None
    for qid in range(qdb.size):
        t0 = time.perf_counter()
        ctx = aligner.init_query(qdb.seq_num(qid))
        cap = 255 - ctx.bias
        STATS["host_s"] += time.perf_counter() - t0
        scores = None
        if use_server:
            from ..server.device_server import query_server
            t0 = time.perf_counter()
            scores = query_server(tdb_path, ctx.profile, cap, mode, go, ge)
            STATS["server_s"] += time.perf_counter() - t0
            if scores is None and qid > 0:
                raise RuntimeError("the gpuserver for the target DB went "
                                   "away during the run")
            if scores is None:
                log.warning("no gpuserver running for the target DB; "
                            "computing locally")
                use_server = False
        if t_lens is None and use_server:
            t_lens = np.array([len(tdb.seq_num(i)) for i in range(tdb.size)],
                              dtype=np.int64)
        elif t_lens is None:
            store = TargetStore(tdb, get_device())
            t_lens = store.lens
        if use_server:
            finish(qid, ctx, np.asarray(scores, dtype=np.int32))
            continue
        scan = _Scan(store, ctx.profile, cap, mode, go, ge)
        if pending is not None:
            finish(pending[0], pending[1], pending[2].result())
        pending = (qid, ctx, scan)
    if pending is not None:
        finish(pending[0], pending[1], pending[2].result())
    writer.close()
    return 0


def ungappedprefilter(par, command):
    return prefilter_exhaustive(par, MODE_GAPLESS)


def gappedprefilter(par, command):
    return prefilter_exhaustive(par, MODE_GAPPED)
