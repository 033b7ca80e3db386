"""`fwbw` — forward-backward posterior (MAC) alignment of alignment hits.

Port of mmseqs2_tpu/commands/fwbw_cmd.py (reference
src/alignment/Fwbw.cpp:1071-1190). For every (query, target) pair of the
input alignment DB: the posterior match probabilities and the MAC DP (B5,
ops/fwbw.py; the hand-written kernel on the card), then the backtrace on
the host, and one Matcher::result_t record a pair with score =
int(score_MAC), eval 0, sorted per query by compareHits.

What differs from the JAX command, with the same records out: the kernel
builds each pair's scores from the residues (the JAX command builds a
score matrix a pair on the host), pairs of consecutive queries go to the
card together up to a cell budget (the JAX command sends one query's
targets, padded to a power-of-two bucket), and the backtraces of a batch
are walked together, a step of every pair at a time.
"""

import time

import numpy as np
import torch

from ..align import util as autil
from ..align.aligner import AlnResult, sort_results
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..device import get_device
from ..ops import fwbw as fwbw_ops
from ..utils import log
from .align_cmd import check_criteria
from .common import EncodedDB, fast_atoi, get_sub_mat, open_seq_db

# cells (query x target residues) of one batch of consecutive queries: on
# the card the kernel's scratch takes 9 B a cell (log zm of both directions
# and the states). The plain version pads the pairs of a call to their
# longest target and query: a batch goes to it by target length, in runs of
# at most PLAIN_CELLS padded cells.
BATCH_CELLS = 1 << 27
PLAIN_CELLS = 1 << 23

# Counters, summed until reset_stats(): queries, pairs, batches, their real
# cells, B5 launches, the kernels' device milliseconds (CUDA events; 0 on
# the CPU), seconds the host waited for a batch's results (wait_s), and
# seconds of host work: parsing and packing (pack_s), the backtraces
# (backtrace_s), records, filter and write (write_s).
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(queries=0, pairs=0, batches=0, cells=0, launches=0,
                 kernel_ms=0.0, wait_s=0.0, pack_s=0.0, backtrace_s=0.0,
                 write_s=0.0)


reset_stats()


def _chunks(q_lens, t_lens, cuda):
    """The pairs of one B5 call each, as index arrays: the whole batch on
    the card; for the plain version the pairs by (query length, target
    length), in runs of at most PLAIN_CELLS padded cells (at least one
    pair)."""
    if cuda:
        yield np.arange(len(t_lens))
        return
    order = np.lexsort((t_lens, q_lens))
    lo, mq, mt = 0, 0, 0
    for n, b in enumerate(order):
        nq, nt = max(mq, q_lens[b]), max(mt, t_lens[b])
        if n > lo and (n - lo + 1) * nq * nt > PLAIN_CELLS:
            yield order[lo:n]
            lo, nq, nt = n, q_lens[b], t_lens[b]
        mq, mt = nq, nt
    if lo < len(order):
        yield order[lo:]


def _run_batch(batch, mat_t, go, ge, temp, mact, device):
    """B5 and the backtraces of a batch of queries (dicts with "q_num" and
    "targets", a list of (key, residues)): per pair, in input order, its
    alignment dict."""
    queries = [q["q_num"] for q in batch]
    targets, pq = [], []
    for qi, q in enumerate(batch):
        for _, t_num in q["targets"]:
            targets.append(t_num)
            pq.append(qi)
    cuda = device.type == "cuda"
    pq = np.asarray(pq, dtype=np.int64)
    q_lens = np.array([len(q) for q in queries], dtype=np.int64)[pq]
    walks = [None] * len(targets)
    for sel in _chunks(q_lens, np.array([len(t) for t in targets]), cuda):
        t0 = time.perf_counter()
        chunk = [targets[b] for b in sel]
        pairs = fwbw_ops.make_pairs(queries, chunk, pq[sel],
                                    range(len(sel)), device)
        STATS["pack_s"] += time.perf_counter() - t0
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        before = fwbw_ops.fwbw.launches
        out = fwbw_ops.fwbw(pairs, mat_t, go, ge, temp, mact)
        if cuda:
            ev[1].record()
        t0 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        STATS["wait_s"] += time.perf_counter() - t0
        if cuda:
            STATS["kernel_ms"] += ev[0].elapsed_time(ev[1])
        STATS["launches"] += fwbw_ops.fwbw.launches - before
        STATS["batches"] += 1
        STATS["pairs"] += pairs.size
        STATS["cells"] += pairs.n_cells

        t0 = time.perf_counter()
        t_off = np.zeros(len(chunk), dtype=np.int64)
        t_off[1:] = np.cumsum([len(t) for t in chunk])[:-1]
        q_off = np.zeros(len(queries), dtype=np.int64)
        q_off[1:] = np.cumsum([len(q) for q in queries])[:-1]
        walk = fwbw_ops.backtrace(
            host["bt"], pairs.cell_off.cpu().numpy(),
            pairs.q_len.cpu().numpy(), host["bi"], host["bj"],
            np.concatenate(chunk), t_off, np.concatenate(queries),
            q_off[pq[sel]])
        for b, pair in enumerate(sel):
            walks[pair] = dict(
                cigar=walk["cigar"][b], q_start=int(walk["q_start"][b]),
                q_end=int(walk["q_end"][b]), t_start=int(walk["t_start"][b]),
                t_end=int(walk["t_end"][b]),
                identities=int(walk["identities"][b]),
                score_mac=float(host["score"][b]))
        STATS["backtrace_s"] += time.perf_counter() - t0
    return walks


def fwbw(par, command):
    q_path, t_path, aln_path, out_path = par.filenames[:4]
    qreader = open_seq_db(q_path)
    if qreader.base_type == dbt.DBTYPE_NUCLEOTIDES:
        log.die("Invalid datatype. Nucleotide.")
    same_db = q_path == t_path
    treader = qreader if same_db else open_seq_db(t_path)
    submat = get_sub_mat(par, score_bias=par.score_bias)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    alns = DBReader(aln_path)
    mat = np.asarray(submat.sub_matrix, np.float32)
    device = get_device()
    mat_t = torch.from_numpy(mat).to(device)

    go = -float(par.fwbw_gapopen)
    ge = -float(par.fwbw_gapextend)
    temp = float(par.temperature)
    mact = float(par.mact)

    def codes(num):
        if len(num) and int(num.max()) >= mat.shape[0]:
            raise ValueError(f"fwbw: residue code {int(num.max())} outside "
                             f"the {mat.shape[0]}-letter matrix")
        return num

    def flush(writer, batch):
        results = _run_batch(batch, mat_t, go, ge, temp, mact, device)
        t0 = time.perf_counter()
        it = iter(results)
        for q in batch:
            qlen = len(q["q_num"])
            out = []
            for (tkey, t_num), a in zip(q["targets"], it):
                tlen = len(t_num)
                bt = a["cigar"]
                aln_len = len(bt)
                seq_id = autil.compute_seq_id(par.seq_id_mode,
                                              a["identities"], qlen, tlen,
                                              aln_len)
                r = AlnResult(
                    db_key=tkey, score=int(a["score_mac"]), raw_score=0,
                    seq_id=seq_id, eval=0.0,
                    q_start=a["q_start"], q_end=a["q_end"], q_len=qlen,
                    db_start=a["t_start"], db_end=a["t_end"], db_len=tlen,
                    qcov=autil.compute_cov(a["q_start"], a["q_end"], qlen),
                    dbcov=autil.compute_cov(a["t_start"], a["t_end"], tlen),
                    aln_length=aln_len, backtrace=bt)
                if check_criteria(r, False, par.evalue, par.min_seq_id,
                                  par.min_aln_len, par.cov_mode,
                                  par.cov_thr):
                    out.append(r)
            sort_results(out)
            writer.write(q["key"],
                         "".join(r.to_line(True) for r in out).encode())
            STATS["queries"] += 1
        STATS["write_s"] += time.perf_counter() - t0

    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed)) as writer:
        batch, cells = [], 0
        for i in range(alns.size):
            t0 = time.perf_counter()
            key = alns.get_db_key(i)
            q_num = codes(qdb.seq_num(qreader.get_id(key)))
            targets = []
            for line in alns.get_data(i).split(b"\n"):
                if not line:
                    continue
                tkey = fast_atoi(line.split(b"\t")[0])
                targets.append((tkey, codes(tdb.seq_num(treader.get_id(
                    tkey)))))
            STATS["pack_s"] += time.perf_counter() - t0
            need = len(q_num) * sum(len(t) for _, t in targets)
            if batch and cells + need > BATCH_CELLS:
                flush(writer, batch)
                batch, cells = [], 0
            batch.append(dict(key=key, q_num=q_num, targets=targets))
            cells += need
        if batch:
            flush(writer, batch)
    alns.close()
    qreader.close()
    if not same_db:
        treader.close()
    return 0
