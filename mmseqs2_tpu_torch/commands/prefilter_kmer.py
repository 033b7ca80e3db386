"""`prefilter`: the k-mer inverted-index double-diagonal-match prefilter.

Port of mmseqs2_tpu/commands/prefilter_kmer.py for protein sequence queries
against a protein sequence target DB held whole on one device.

Reference: src/prefiltering/Prefiltering.cpp: seed matrix VTML80 at 8-bit
scaling with -0.2 bias, ungapped rescoring matrix at 2-bit (getSubstitutionMatrix
:1009-1025), k-mer threshold from sensitivity (getKmerThreshold :1036-1075),
k auto-sized 6/7 from DB residues (IndexTable.h:441-443), tantan-masked index
build with self-score k-mer pruning (IndexBuilder.cpp), per-query matching in
prefilter/query_matcher.py, output `targetKey \\t diagScore \\t diagonal`.

The batched device matcher (prefilter/device.py) runs whenever diagonal
scoring is on, on the device that device.get_device() names; the host
matcher serves --diag-score 0 and is the oracle of the device path. Profile
and nucleotide DBs, --taxon-list and target-split mode are not yet ported
(see ROADMAP.md) and raise.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..align import util as autil
from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.writer import DBWriter
from ..device import get_device
from ..ops.tantan import likelihood_ratio_matrix, mask_batch
from ..prefilter.device import NOT_PORTED, DevicePrefilter
from ..prefilter.index_io import index_path_for, load_index, load_index_meta
from ..prefilter.kmer_generator import KmerGenerator, SubKmerScores
from ..prefilter.kmer_index import KmerIndexTable
from ..prefilter.query_matcher import QueryMatcher
from ..utils import log
from .common import EncodedDB, open_seq_db

INT_MAX = 2147483647

# Counters of the prefilter stage, summed over every run until reset_stats():
# host seconds of the index build, of stage-0 (summed over the pool's
# workers), of dispatching flushes, of waiting for them and of writing hits;
# flushes, queries, queries matched again by the host oracle, hits written;
# with RECORD_RESCORE set, one dict per flush's diag_rescore: its slots,
# valid candidates and the histogram of its windows' lengths
# (prefilter/device.py: WINDOW_BIN cells a bin).
STATS = {}
RECORD_RESCORE = False


def reset_stats():
    STATS.clear()
    STATS.update(index_s=0.0, prep_s=0.0, dispatch_s=0.0, wait_s=0.0,
                 write_s=0.0, flushes=0, queries=0, host_oracle_queries=0,
                 hits=0, rescore=[])


reset_stats()


def get_kmer_threshold(sensitivity: float, kmer_size: int,
                       k_score: int = INT_MAX,
                       is_profile: bool = False) -> int:
    """Prefiltering::getKmerThreshold (Prefiltering.cpp:1036-1090)."""
    if k_score != INT_MAX:
        return k_score
    if is_profile:
        # no-context-pseudo-counts profile branch
        base_sens = {5: (108.8, 4.7), 6: (134.35, 6.15), 7: (149.15, 6.85)}
    else:
        base_sens = {5: (160.75, 12.75), 6: (163.2, 8.917), 7: (186.15, 11.22)}
    if kmer_size not in base_sens:
        raise ValueError(f"invalid k-mer size {kmer_size}")
    base, per = base_sens[kmer_size]
    # float base - (float sens * double per) -> float, then int truncation
    best = np.float32(np.float64(np.float32(base))
                      - np.float64(np.float32(sensitivity)) * per)
    return int(best)


def compute_kmer_size(residues: int) -> int:
    return 6 if residues < 3350000000 else 7


def build_index(tdb: EncodedDB, seed, kmer_size: int, kmer_thr: int,
                mask: bool, mask_prob: float, mask_lower: bool,
                spaced: bool, pattern: str):
    alpha = seed.alphabet_size - 1      # X removed for seeding
    x_idx = seed.alphabet_size - 1
    seqs = [tdb.seq_num(i).astype(np.uint8) for i in range(tdb.size)]
    if mask:
        lr = likelihood_ratio_matrix(seed)
        masked, n_masked = mask_batch(seqs, lr, x_idx, mask_prob)
        log.info(f"Index table: Masked residues: {n_masked}")
    else:
        masked = seqs
    if mask_lower:
        for i, s in enumerate(masked):
            raw = tdb.reader.get_seq(i)
            lower = np.frombuffer(raw, dtype=np.uint8) >= ord('a')
            s = s.copy()
            s[lower[: len(s)]] = x_idx
            masked[i] = s
    self_score = np.diag(seed.sub_matrix).astype(np.int64)
    table = KmerIndexTable(alpha, kmer_size, spaced, pattern)
    table.build(masked, x_idx, kmer_thr, self_score)
    return table


def prefilter_kmer(par, command):
    qdb_path, tdb_path, out_path = par.filenames[:3]
    same_db = qdb_path == tdb_path

    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    for reader in (qreader, treader):
        if reader.base_type == dbt.DBTYPE_NUCLEOTIDES:
            raise NotImplementedError(
                f"the nucleotide prefilter {NOT_PORTED}")
        if reader.base_type == dbt.DBTYPE_HMM_PROFILE:
            raise NotImplementedError(
                f"the profile prefilter {NOT_PORTED}")
    if par.taxon_list:
        raise NotImplementedError(f"prefilter --taxon-list {NOT_PORTED}")
    if par.diag_score:
        n_splits = par.split if par.split_mode in (0, 2) else 0
        if n_splits == 0 and par.split_mode in (0, 2):
            # setupSplit analogue (Prefiltering.cpp:287-310): pick the
            # target split count from the device-memory budget and the
            # index footprint
            n_splits = _auto_split_count(treader, par)
        if n_splits > 1:
            raise NotImplementedError(
                f"target-split mode ({n_splits} splits of the target DB) "
                f"{NOT_PORTED}")
    seed = get_submat(par.seed_sub_mat.aa, 8.0, -0.2)
    ungapped = get_submat(par.sub_mat.aa, 2.0, -0.2)
    qdb = EncodedDB(qreader, seed)
    tdb = qdb if same_db else EncodedDB(treader, seed)

    # prebuilt-index parameter adoption (Prefiltering.cpp:111-160): flags
    # the user did NOT set take the index's values, so a `<db>.idx` built
    # at another sensitivity/k is used instead of triggering a rebuild
    idx_path = index_path_for(tdb_path)
    if idx_path is not None:
        try:
            _m = load_index_meta(idx_path)
            if not bool(_m.get("nucl", 0)):
                if not par.was_set("kmer_size") and _m.get("k"):
                    par.set("kmer_size", int(_m["k"]))
                if (not par.was_set("sensitivity")
                        and _m.get("sensitivity") is not None):
                    par.set("sensitivity", float(_m["sensitivity"]))
                if not par.was_set("spaced_kmer_mode"):
                    par.set("spaced_kmer_mode", int(_m.get("spaced", 1)))
                if not par.was_set("mask"):
                    par.set("mask", int(_m.get("mask", 1)))
        except Exception as e:
            log.warning(f"ignoring unreadable index {idx_path}: {e}")

    kmer_size = par.kmer_size or compute_kmer_size(treader.total_residues())
    kmer_thr = get_kmer_threshold(par.sensitivity, kmer_size, par.k_score.aa)
    log.info(f"k-mer similarity threshold: {kmer_thr} (k = {kmer_size})")

    # exact k-mer matching (takeOnlyBestKmer, Prefiltering.cpp:188-192)
    take_only_best = par.exact_kmer_matching == 1

    spaced = par.spaced_kmer_mode == 1
    alpha = seed.alphabet_size - 1
    t0 = time.perf_counter()
    table = None
    if idx_path is not None:
        try:
            cand, meta = load_index(idx_path)
            if (cand.k == kmer_size and cand.alpha == alpha
                    and meta.get("kmer_thr") == kmer_thr
                    and meta.get("spaced") == int(spaced)
                    and meta.get("mask") == int(par.mask)):
                table = cand
                log.info(f"Using prebuilt index {idx_path}")
            else:
                log.info(f"Prebuilt index {idx_path} incompatible with "
                         "requested parameters; rebuilding")
        except Exception as e:            # corrupt/old index: rebuild
            log.warning(f"Failed to load prebuilt index {idx_path}: {e}")
    if table is None:
        table = build_index(tdb, seed, kmer_size, kmer_thr,
                            par.mask == 1, par.mask_prob,
                            par.mask_lower_case == 1, spaced,
                            par.spaced_kmer_pattern)
    log.info(f"Index table: {len(table.entries_seq)} k-mer positions")

    if take_only_best:
        generator = None      # exact match only
    else:
        three = SubKmerScores(seed.sub_matrix, alpha, 3).attach_disk_cache()
        two = SubKmerScores(seed.sub_matrix, alpha, 2).attach_disk_cache()
        generator = KmerGenerator(kmer_size, alpha, three, two)
    STATS["index_s"] += time.perf_counter() - t0

    matcher = QueryMatcher(
        table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
        par.comp_bias_corr, par.comp_bias_corr_scale,
        par.min_ungapped_score, generator,
        take_only_best_kmer=take_only_best, is_nucleotide=False)

    # the batched device matcher serves diagonal scoring; the host numpy
    # matcher stays the oracle (and handles --diag-score 0)
    if not par.diag_score:
        return _run_host(par, qreader, treader, qdb, matcher, same_db,
                         out_path)
    dev = DevicePrefilter(
        table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
        par.comp_bias_corr, par.comp_bias_corr_scale,
        par.min_ungapped_score, generator,
        take_only_best_kmer=take_only_best, host_fallback=matcher)
    dev.record_rescore = RECORD_RESCORE
    return _run_device(par, qreader, treader, qdb, dev, same_db, out_path)


def _write_hits(writer, par, treader, q_key, q_len, hits):
    check_cov = par.cov_thr > 0.0 and par.cov_mode in (0, 2, 5)
    lines = []
    for tid, score, diag in hits:
        # output coverage gate (Prefiltering.cpp:885-893)
        if check_cov and not autil.can_be_covered(
                par.cov_thr, par.cov_mode, q_len,
                float(treader.get_seq_len(tid))):
            continue
        t_key = treader.get_db_key(tid)
        lines.append(f"{t_key}\t{score}\t{diag}\n")
    writer.write(q_key, "".join(lines).encode())
    return len(lines)


def _identity_id(par, qreader, treader, same_db, q_key):
    if same_db or par.include_identity:
        tid = treader.get_id(q_key)
        if tid >= 0:
            return tid
    return -1


def _run_device(par, qreader, treader, qdb, dev, same_db, out_path):
    """Batched device prefilter: accumulate prepared queries until the hit
    budget fills, then enqueue one device match per batch, two flushes in
    flight."""
    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    batch, budget = [], 0
    reslens = []
    pending = []                 # [(items, pending-handle)]
    oracle0 = dev.host_oracle_queries

    def write_batch(items, hit_lists):
        for b, hits in zip(items, hit_lists):
            reslens.append(_write_hits(writer, par, treader, b["key"],
                                       b["qlen"], hits))

    def flush(drain=False):
        nonlocal batch, budget
        if batch:
            t0 = time.perf_counter()
            pend = dev.match_batch_async(
                [b["q"] for b in batch], [b["ident"] for b in batch],
                prepared=[b["prep"] for b in batch])
            STATS["dispatch_s"] += time.perf_counter() - t0
            STATS["flushes"] += 1
            pending.append((batch, pend))
            batch, budget = [], 0
        # keep two dispatches in flight: the device works on flush N and
        # has N+1 queued behind it while the host prepares N+2 and writes
        # N-1
        while pending and (drain or len(pending) > 2):
            items, pend = pending.pop(0)
            t0 = time.perf_counter()
            hit_lists = dev.match_batch_wait(pend)
            t1 = time.perf_counter()
            write_batch(items, hit_lists)
            STATS["wait_s"] += t1 - t0
            STATS["write_s"] += time.perf_counter() - t1

    def make_item(qid):
        q_key = qreader.get_db_key(qid)
        return {"key": q_key, "q": qdb.seq_num(qid),
                "ident": _identity_id(par, qreader, treader, same_db, q_key),
                "qlen": float(qreader.get_seq_len(qid))}

    def prep(item):
        t0 = time.perf_counter()
        item["prep"] = dev.prepare_query(item["q"])
        item["prep_s"] = time.perf_counter() - t0
        return item

    def consume(item):
        # prepared up front (threaded) so the flush decision sees the
        # ACTUAL expansion volume
        nonlocal batch, budget
        STATS["prep_s"] += item.pop("prep_s")
        vol = len(item["prep"][5])
        if batch and (budget + vol > dev.H_CAP_FIXED
                      or len(batch) >= dev.B_PAD):
            flush()
        batch.append(item)
        budget += vol

    # host stage-0 across a thread pool, CHUNK items ahead (numpy releases
    # the GIL in the bulk ops; the reference's analogue is the per-thread
    # QueryMatcher loop, Prefiltering.cpp:605-689)
    CHUNK = 256
    workers = min(8, os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for lo in range(0, qreader.size, CHUNK):
            hi = min(lo + CHUNK, qreader.size)
            for item in pool.map(prep, map(make_item, range(lo, hi))):
                consume(item)
    flush(drain=True)
    writer.close()
    STATS["queries"] += qreader.size
    STATS["host_oracle_queries"] += dev.host_oracle_queries - oracle0
    STATS["hits"] += sum(reslens)
    STATS["rescore"] += dev.rescore_log
    _print_statistics(None, reslens, qreader.size, par.max_seqs)
    return 0


def _parse_mem_limit(s: str) -> int:
    """'750M'/'7G'/'0' -> bytes (Util::parseByteSize semantics)."""
    s = (s or "0").strip()
    mult = 1
    if s and s[-1] in "kKmMgGtT":
        mult = {"k": 1 << 10, "m": 1 << 20,
                "g": 1 << 30, "t": 1 << 40}[s[-1].lower()]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        return 0


def _device_mem_budget(par) -> int:
    """Device-memory budget for the resident index: --split-memory-limit if
    set, else three quarters of the card's memory, else (on the CPU) a
    12 GiB default."""
    lim = _parse_mem_limit(par.split_memory_limit)
    if lim > 0:
        return lim
    if get_device().type == "cuda":
        _, total = torch.cuda.mem_get_info()
        return int(total * 0.75)
    return 12 << 30


def _auto_split_count(treader, par) -> int:
    """Target split count so the device-resident index fits the budget.

    Footprint per residue: 6 B packed index entry (u32 seq id + u16 pos,
    IndexTable.h:25-30 parity) + 1 B sequence store; + per-sequence
    bookkeeping; + ~2x headroom for the per-batch working buffers."""
    residues = treader.total_residues()
    need = int((6 + 1) * residues + 16 * treader.size) * 2
    budget = _device_mem_budget(par)
    return max(1, -(-need // max(budget, 1)))


def _print_statistics(stats_acc, reslens, n_queries, max_results):
    """Prefiltering::printStatistics (Prefiltering.cpp:984-1006)."""
    if n_queries == 0:
        return
    if stats_acc is not None:
        kpp, dbm, dbl = stats_acc
        log.info(f"\n{kpp / n_queries:g} k-mers per position")
        log.info(f"{dbm // n_queries} DB matches per sequence")
        log.info("0 overflows")
    passed = sum(reslens) // n_queries
    msg = f"{passed} sequences passed prefiltering per query sequence"
    if passed > max_results:
        log.warning(msg + f" (ATTENTION: max. {max_results} best scoring "
                    "sequences were written to the output prefiltering "
                    "database)")
    else:
        log.info(msg)
    sl = sorted(reslens)
    log.info(f"{sl[len(sl) // 2]} median result list length")
    log.info(f"{sum(1 for r in reslens if r == 0)} sequences with 0 size "
             "result lists")


def _run_host(par, qreader, treader, qdb, matcher, same_db, out_path):
    """Per-query host (numpy oracle) matching loop."""
    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    stats_acc = [0.0, 0, 0]
    reslens = []
    for qid in range(qreader.size):
        q_key = qreader.get_db_key(qid)
        hits = matcher.match(
            qdb.seq_num(qid),
            _identity_id(par, qreader, treader, same_db, q_key),
            diagonal_scoring=bool(par.diag_score))
        reslens.append(_write_hits(writer, par, treader, q_key,
                                   float(qreader.get_seq_len(qid)), hits))
        stats_acc[0] += matcher.stats.kmers_per_pos
        stats_acc[1] += matcher.stats.db_matches
        stats_acc[2] += matcher.stats.double_matches
    writer.close()
    STATS["queries"] += qreader.size
    STATS["hits"] += sum(reslens)
    _print_statistics(stats_acc, reslens, qreader.size, par.max_seqs)
    return 0
