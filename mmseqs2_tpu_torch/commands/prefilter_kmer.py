"""`prefilter`: the k-mer inverted-index double-diagonal-match prefilter.

Port of mmseqs2_tpu/commands/prefilter_kmer.py for protein sequence and
profile queries against a protein sequence target DB held whole on one
device, and for sequence queries against a profile target DB (on the host
matcher, as in the JAX package and the reference).

Reference: src/prefiltering/Prefiltering.cpp: seed matrix VTML80 at 8-bit
scaling with -0.2 bias, ungapped rescoring matrix at 2-bit (getSubstitutionMatrix
:1009-1025), k-mer threshold from sensitivity (getKmerThreshold :1036-1075),
k auto-sized 6/7 from DB residues (IndexTable.h:441-443), tantan-masked index
build with self-score k-mer pruning (IndexBuilder.cpp), per-query matching in
prefilter/query_matcher.py, output `targetKey \\t diagScore \\t diagonal`.

The batched device matcher (prefilter/device.py) runs whenever diagonal
scoring is on, on the device that device.get_device() names; the host
matcher serves --diag-score 0 and profile targets, and is the oracle of the
device path. Target-split mode (--split N, or the split count that
_auto_split_count derives from --split-memory-limit or the card's memory)
builds one index per contiguous slice of the targets and merges the
per-split candidates exactly (_run_device_splits): its output is the
unsplit run's, byte for byte. Nucleotide DBs and --taxon-list are not yet
ported (see ROADMAP.md) and raise.
"""

import os
import shutil
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
from ..ops.encode import calc_local_aa_bias
from ..ops.rescore import profile_rows
from ..prefilter.device import (NOT_PORTED, DevicePrefilter,
                                bias_correction, query_triples)
from ..prefilter.index_io import index_path_for, load_index, load_index_meta
from ..prefilter.kmer_generator import (KmerGenerator, ProfileKmerGenerator,
                                        SubKmerScores)
from ..prefilter.kmer_index import KmerIndexTable, pattern_offsets
from ..prefilter.query_matcher import QueryMatcher
from ..prefilter.split_merge import finalize_query, self_ungapped_score
from ..profile.io import kmer_rows, parse_profile
from ..utils import log
from .common import EncodedDB, open_seq_db

INT_MAX = 2147483647

# Counters of the prefilter stage, summed over every run until reset_stats():
# host seconds of the index build, of stage-0 (summed over the pool's
# workers; for profile queries mostly their k-mer enumeration), of
# dispatching flushes, of waiting for them and of writing hits; flushes,
# queries, queries matched again by the host oracle, hits written, bytes of
# profile-query rescore profiles uploaded; with RECORD_RESCORE set, one
# dict per flush's diag_rescore: its slots, valid candidates and the
# histogram of its windows' lengths (prefilter/device.py: WINDOW_BIN cells
# a bin). Target-split mode adds per split its index build's and its
# candidate stage's seconds (split_index_s, split_candidates_s, one entry a
# split), the merge's seconds and the bytes spilled to <out>.split_tmp;
# its stage-0 counts in prep_s, its device calls in flushes.
STATS = {}
RECORD_RESCORE = False
# queries a chunk of target-split mode: one chunk's stage-0 and fragments
# are in host memory at a time
SPLIT_QCHUNK = 1024


def reset_stats():
    STATS.clear()
    STATS.update(index_s=0.0, prep_s=0.0, dispatch_s=0.0, wait_s=0.0,
                 write_s=0.0, flushes=0, queries=0, host_oracle_queries=0,
                 hits=0, profile_bytes=0, rescore=[], split_index_s=[],
                 split_candidates_s=[], split_merge_s=0.0,
                 split_spill_bytes=0)


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
                spaced: bool, pattern: str, seq_range=None):
    """seq_range=(lo, hi): build over a contiguous target slice with local
    ids 0..hi-lo (the per-split index of the reference's target-split mode,
    Prefiltering.cpp:755-786)."""
    alpha = seed.alphabet_size - 1      # X removed for seeding
    x_idx = seed.alphabet_size - 1
    lo, hi = seq_range if seq_range is not None else (0, tdb.size)
    seqs = [tdb.seq_num(i).astype(np.uint8) for i in range(lo, hi)]
    if mask:
        lr = likelihood_ratio_matrix(seed)
        masked, n_masked = mask_batch(seqs, lr, x_idx, mask_prob)
        log.info(f"Index table: Masked residues: {n_masked}")
    else:
        masked = seqs
    if mask_lower:
        for i, s in enumerate(masked):
            raw = tdb.reader.get_seq(lo + i)
            lower = np.frombuffer(raw, dtype=np.uint8) >= ord('a')
            s = s.copy()
            s[lower[: len(s)]] = x_idx
            masked[i] = s
    self_score = np.diag(seed.sub_matrix).astype(np.int64)
    table = KmerIndexTable(alpha, kmer_size, spaced, pattern)
    table.build(masked, x_idx, kmer_thr, self_score)
    return table


def build_profile_target_index(treader, seed, kmer_size: int,
                               kmer_thr: int, spaced: bool, pattern: str):
    """Index over DBTYPE_HMM_PROFILE targets: each profile's windows expand
    into all k-mers scoring >= kmerThr against the per-position profile rows
    (IndexBuilder.cpp isProfile branch + IndexTable::addSimilarSequence,
    IndexTable.h:304-348 — unique k-mer per profile, first position wins).
    The sequence store holds the profiles' query letters (Sequence.cpp:314)
    for the ungapped diagonal rescore."""
    alpha = seed.alphabet_size - 1
    x_idx = seed.alphabet_size - 1
    offsets_pat, span = pattern_offsets(kmer_size, spaced, pattern)
    table = KmerIndexTable(alpha, kmer_size, spaced, pattern)
    all_kmer, all_seq, all_pos = [], [], []
    seqs = []
    for sid in range(treader.size):
        p = parse_profile(treader.get_data(sid))
        q_num = p.query_num.astype(np.int64)
        seqs.append(q_num.astype(np.uint8))
        ss, si = kmer_rows(p)
        gen = ProfileKmerGenerator(kmer_size, alpha, ss, si, offsets_pat)
        n = p.length - span + 1
        if n <= 0:
            continue
        pos = np.arange(n, dtype=np.int64)
        wins = q_num[pos[:, None] + offsets_pat[None, :]]
        ok = ~(wins == x_idx).any(axis=1)
        pos, wins = pos[ok], wins[ok]
        if len(pos) == 0:
            continue
        codes, win_of = gen.generate_all(
            wins, np.full(len(pos), kmer_thr, np.int64), pos)
        if len(codes) == 0:
            continue
        kpos = pos[win_of]
        # unique k-mer per profile, first (smallest) position wins
        order = np.lexsort((kpos, codes))
        codes, kpos = codes[order], kpos[order]
        first = np.ones(len(codes), dtype=bool)
        first[1:] = codes[1:] != codes[:-1]
        all_kmer.append(codes[first])
        all_seq.append(np.full(int(first.sum()), sid, np.int64))
        all_pos.append(kpos[first])
    kmers = (np.concatenate(all_kmer) if all_kmer
             else np.zeros(0, np.int64))
    seqs_a = (np.concatenate(all_seq) if all_seq
              else np.zeros(0, np.int64))
    poss = (np.concatenate(all_pos) if all_pos
            else np.zeros(0, np.int64))
    order = np.argsort(kmers, kind="stable")
    kmers, seqs_a, poss = kmers[order], seqs_a[order], poss[order]
    table.sparse = table.table_size > (1 << 26)
    if table.sparse:
        table.uniq_kmers, counts = (np.unique(kmers, return_counts=True)
                                    if len(kmers)
                                    else (np.zeros(0, np.int64),
                                          np.zeros(0, np.int64)))
        table.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
    else:
        counts = np.bincount(kmers, minlength=table.table_size) \
            if len(kmers) else np.zeros(table.table_size, dtype=np.int64)
        table.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
    table.entries_seq = seqs_a
    table.entries_pos = poss.astype(np.uint16)
    table.masked_seqs = seqs
    return table


def profile_query(p, k, alpha, offsets_pat):
    """A profile query's k-mer generator (its rankedDescSort20 rows) and its
    (L, alpha + 1) diagonal-rescore profile: pssm/4 truncated toward zero on
    the 20 amino-acid columns, X column 0."""
    ss, si = kmer_rows(p)
    gen = ProfileKmerGenerator(k, alpha, ss, si, offsets_pat)
    s = p.scores.astype(np.int64)
    rescore = np.zeros((p.length, alpha + 1), dtype=np.int64)
    rescore[:, :20] = np.sign(s) * (np.abs(s) // 4)
    return gen, rescore


def prefilter_kmer(par, command):
    qdb_path, tdb_path, out_path = par.filenames[:3]
    same_db = qdb_path == tdb_path

    qreader = open_seq_db(qdb_path)
    treader = qreader if same_db else open_seq_db(tdb_path)
    for reader in (qreader, treader):
        if reader.base_type == dbt.DBTYPE_NUCLEOTIDES:
            raise NotImplementedError(
                f"the nucleotide prefilter {NOT_PORTED}")
    query_is_profile = qreader.base_type == dbt.DBTYPE_HMM_PROFILE
    target_is_profile = treader.base_type == dbt.DBTYPE_HMM_PROFILE
    if par.taxon_list:
        raise NotImplementedError(f"prefilter --taxon-list {NOT_PORTED}")
    n_splits = 0
    if par.diag_score and not target_is_profile:
        n_splits = par.split if par.split_mode in (0, 2) else 0
        if n_splits == 0 and par.split_mode in (0, 2):
            # setupSplit analogue (Prefiltering.cpp:287-310): pick the
            # target split count from the device-memory budget and the
            # index footprint
            n_splits = _auto_split_count(treader, par)
            if n_splits > 1:
                log.info(f"Automatic target split: {n_splits} splits "
                         f"(device memory budget)")
    if query_is_profile:
        # profile queries use the scoring matrix for target background only
        # (Prefiltering.cpp:72-77); index k-mer threshold is 0 (:555-557)
        seed = get_submat(par.sub_mat.aa, 8.0, -0.2)
    else:
        seed = get_submat(par.seed_sub_mat.aa, 8.0, -0.2)
    ungapped = get_submat(par.sub_mat.aa, 2.0, -0.2)
    qdb = None if query_is_profile else EncodedDB(qreader, seed)
    tdb = (qdb if same_db and not query_is_profile
           else EncodedDB(treader, seed))

    # prebuilt-index parameter adoption (Prefiltering.cpp:111-160): flags
    # the user did NOT set take the index's values, so a `<db>.idx` built
    # at another sensitivity/k is used instead of triggering a rebuild
    idx_path = index_path_for(tdb_path)
    if idx_path is not None and not target_is_profile:
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
    kmer_thr = get_kmer_threshold(
        par.sensitivity, kmer_size, par.k_score.aa,
        is_profile=query_is_profile or target_is_profile)
    log.info(f"k-mer similarity threshold: {kmer_thr} (k = {kmer_size})")

    # exact k-mer matching (takeOnlyBestKmer, Prefiltering.cpp:188-192)
    take_only_best = (par.exact_kmer_matching == 1
                      or (target_is_profile and not query_is_profile))

    spaced = par.spaced_kmer_mode == 1
    alpha = seed.alphabet_size - 1
    if query_is_profile or take_only_best or target_is_profile:
        generator = None      # per-query rows / exact match / host matcher
    else:
        three = SubKmerScores(seed.sub_matrix, alpha, 3).attach_disk_cache()
        two = SubKmerScores(seed.sub_matrix, alpha, 2).attach_disk_cache()
        generator = KmerGenerator(kmer_size, alpha, three, two)
    t0 = time.perf_counter()
    if target_is_profile:
        # profile targets run on the host matcher (the reference's and the
        # JAX package's route)
        table = build_profile_target_index(
            treader, seed, kmer_size, kmer_thr, spaced,
            par.spaced_kmer_pattern)
        STATS["index_s"] += time.perf_counter() - t0
        log.info(f"Index table: {len(table.entries_seq)} k-mer positions")
        matcher = QueryMatcher(
            table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
            par.comp_bias_corr, par.comp_bias_corr_scale,
            par.min_ungapped_score, None,
            take_only_best_kmer=take_only_best, is_nucleotide=False)
        return _run_host(par, qreader, treader, qdb, matcher,
                         query_is_profile, same_db, out_path, alpha)
    index_thr = 0 if query_is_profile else kmer_thr
    if n_splits > 1:
        return _run_device_splits(
            par, qreader, treader, qdb, tdb, seed, ungapped, kmer_size,
            kmer_thr, index_thr, spaced, generator, take_only_best,
            query_is_profile, same_db, out_path, n_splits)
    table = None
    if idx_path is not None:
        try:
            cand, meta = load_index(idx_path)
            if (cand.k == kmer_size and cand.alpha == alpha
                    and meta.get("kmer_thr") == index_thr
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
        table = build_index(tdb, seed, kmer_size, index_thr,
                            par.mask == 1, par.mask_prob,
                            par.mask_lower_case == 1, spaced,
                            par.spaced_kmer_pattern)
    log.info(f"Index table: {len(table.entries_seq)} k-mer positions")
    STATS["index_s"] += time.perf_counter() - t0

    matcher = QueryMatcher(
        table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
        par.comp_bias_corr, par.comp_bias_corr_scale,
        par.min_ungapped_score, generator,
        take_only_best_kmer=take_only_best, is_nucleotide=False)

    # the batched device matcher serves diagonal scoring; the host numpy
    # matcher stays the oracle (and handles --diag-score 0)
    if not par.diag_score:
        return _run_host(par, qreader, treader, qdb, matcher,
                         query_is_profile, same_db, out_path, alpha)
    dev = DevicePrefilter(
        table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
        par.comp_bias_corr, par.comp_bias_corr_scale,
        par.min_ungapped_score, generator,
        take_only_best_kmer=take_only_best, host_fallback=matcher)
    dev.record_rescore = RECORD_RESCORE
    return _run_device(par, qreader, treader, qdb, dev, query_is_profile,
                       same_db, out_path, alpha)


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


def _run_device(par, qreader, treader, qdb, dev, query_is_profile, same_db,
                out_path, alpha):
    """Batched device prefilter: accumulate prepared queries until the hit
    budget fills, then enqueue one device match per batch, two flushes in
    flight."""
    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    batch, budget = [], 0
    reslens = []
    pending = []                 # [(items, pending-handle)]
    oracle0 = dev.host_oracle_queries
    bytes0 = dev.profile_bytes

    def write_batch(items, hit_lists):
        for b, hits in zip(items, hit_lists):
            reslens.append(_write_hits(writer, par, treader, b["key"],
                                       b["qlen"], hits))

    def flush(drain=False):
        nonlocal batch, budget
        if batch:
            t0 = time.perf_counter()
            rps = [b["rp"] for b in batch] if query_is_profile else None
            gens = [b["gen"] for b in batch] if query_is_profile else None
            pend = dev.match_batch_async(
                [b["q"] for b in batch], [b["ident"] for b in batch],
                rps, gens, prepared=[b["prep"] for b in batch])
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
        item = {"key": q_key,
                "ident": _identity_id(par, qreader, treader, same_db, q_key)}
        if query_is_profile:
            p = parse_profile(qreader.get_data(qid))
            item["gen"], item["rp"] = profile_query(
                p, dev.k, alpha, dev.index.offsets_pat)
            item["q"] = p.query_num.astype(np.int64)
            item["qlen"] = float(p.length)
        else:
            item["q"] = qdb.seq_num(qid)
            item["qlen"] = float(qreader.get_seq_len(qid))
        return item

    def prep(item):
        t0 = time.perf_counter()
        item["prep"] = dev.prepare_query(item["q"], item.get("rp"),
                                         item.get("gen"))
        item["prep_s"] = time.perf_counter() - t0
        return item

    def consume(item):
        # prepared up front (threaded) so the flush decision sees the
        # ACTUAL expansion volume
        nonlocal batch, budget
        prep_s = item.pop("prep_s")
        STATS["prep_s"] += prep_s
        vol = int(item["prep"][1].sum())
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
    STATS["profile_bytes"] += dev.profile_bytes - bytes0
    STATS["hits"] += sum(reslens)
    STATS["rescore"] += dev.rescore_log
    _print_statistics(None, reslens, qreader.size, par.max_seqs)
    return 0


def _run_device_splits(par, qreader, treader, qdb, tdb, seed, ungapped,
                       kmer_size, kmer_thr, index_thr, spaced, generator,
                       take_only_best, query_is_profile, same_db, out_path,
                       n_splits):
    """Out-of-core target-split prefilter (the JAX package's
    _run_device_splits; reference Prefiltering.cpp:755-786): per split an
    index build over its contiguous slice of the targets and the device
    candidate stage (DevicePrefilter.candidates_batch: posting_expand, the
    sort, the rescore, keep-max), then the exact cross-split merge of
    prefilter/split_merge.py. The output is byte-identical to the unsplit
    run.

    Queries go in chunks of SPLIT_QCHUNK: a chunk's stage-0 (k-mer codes
    and positions, the rescore inputs) and its per-split candidate
    fragments spill to <out>.split_tmp, removed at the end, so host memory
    holds one chunk whatever the query count. Stage-0 runs in a thread
    pool, as _run_device's does."""
    nt, nq = treader.size, qreader.size
    bounds = np.linspace(0, nt, n_splits + 1).astype(np.int64)
    log.info(f"Target split mode: {n_splits} splits of ~"
             f"{nt // max(n_splits, 1)} sequences")
    alpha = seed.alphabet_size - 1
    tmpdir = out_path + ".split_tmp"
    os.makedirs(tmpdir, exist_ok=True)
    n_chunks = max(1, -(-nq // SPLIT_QCHUNK))
    # stage-0 needs the seed pattern only, no index
    offsets_pat, span = pattern_offsets(kmer_size, spaced,
                                        par.spaced_kmer_pattern)

    def chunk_range(c):
        return range(c * SPLIT_QCHUNK, min((c + 1) * SPLIT_QCHUNK, nq))

    def spill(name, **arrays):
        path = os.path.join(tmpdir, name)
        np.savez(path, **arrays)
        STATS["split_spill_bytes"] += os.path.getsize(path)

    def stage0(qid):
        """A query's key, identity, length, letters, k-mer codes and
        positions, and rescore input: a profile query's (L, alpha + 1)
        rows, a sequence query's bias correction."""
        t0 = time.perf_counter()
        key = qreader.get_db_key(qid)
        item = dict(key=key, ident=_identity_id(par, qreader, treader,
                                                same_db, key))
        if query_is_profile:
            p = parse_profile(qreader.get_data(qid))
            gen, item["rows"] = profile_query(p, kmer_size, alpha,
                                              offsets_pat)
            q_num = p.query_num.astype(np.int64)
            item["qlen"] = float(p.length)
            comp_bias = np.zeros(len(q_num), np.float32)
        else:
            gen = generator
            q_num = qdb.seq_num(qid)
            item["qlen"] = float(qreader.get_seq_len(qid))
            comp_bias = (calc_local_aa_bias(
                q_num, seed.sub_matrix, seed.pback,
                par.comp_bias_corr_scale) if par.comp_bias_corr
                else np.zeros(len(q_num), np.float32))
            item["corr"] = bias_correction(comp_bias)
        item["codes"], item["qpos"] = query_triples(
            q_num, comp_bias, offsets_pat, span, alpha, alpha, kmer_thr,
            take_only_best, gen)
        item["qnum"] = q_num.astype(np.int32)
        item["prep_s"] = time.perf_counter() - t0
        return item

    def cat(items, name, empty):
        return (np.concatenate([it[name] for it in items]) if items
                else empty)

    workers = min(8, os.cpu_count() or 4)
    try:
        # pass 0: each chunk's stage-0, spilled
        qmeta = []
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for c in range(n_chunks):
                items = list(pool.map(stage0, chunk_range(c)))
                STATS["prep_s"] += sum(it["prep_s"] for it in items)
                qmeta += [dict(key=it["key"], ident=it["ident"],
                               qlen=it["qlen"]) for it in items]
                rows = (cat(items, "rows", np.zeros((0, alpha + 1)))
                        if query_is_profile else np.zeros((0, alpha + 1)))
                spill(f"q{c}.npz",
                      codes=cat(items, "codes", np.zeros(0, np.int64)),
                      qpos=cat(items, "qpos", np.zeros(0, np.int32)),
                      k_of=np.array([len(it["codes"]) for it in items],
                                    np.int64),
                      qnum=cat(items, "qnum", np.zeros(0, np.int32)),
                      n_of=np.array([len(it["qnum"]) for it in items],
                                    np.int64),
                      rows=rows.astype(np.int8),
                      corr=(np.zeros(0, np.int8) if query_is_profile
                            else cat(items, "corr", np.zeros(0, np.int8))))

        def load_chunk(c):
            z = dict(np.load(os.path.join(tmpdir, f"q{c}.npz")))
            z["ko"] = np.concatenate([[0], np.cumsum(z["k_of"])])
            z["no"] = np.concatenate([[0], np.cumsum(z["n_of"])])
            return z

        # per split: its index, then every chunk's candidate fragments
        for s_i in range(n_splits):
            lo, hi = int(bounds[s_i]), int(bounds[s_i + 1])
            t0 = time.perf_counter()
            table = build_index(tdb, seed, kmer_size, index_thr,
                                par.mask == 1, par.mask_prob,
                                par.mask_lower_case == 1, spaced,
                                par.spaced_kmer_pattern, seq_range=(lo, hi))
            dev = DevicePrefilter(
                table, seed, ungapped, kmer_thr, kmer_size, par.max_seqs,
                par.comp_bias_corr, par.comp_bias_corr_scale,
                par.min_ungapped_score, generator,
                take_only_best_kmer=take_only_best)
            t1 = time.perf_counter()
            STATS["split_index_s"].append(t1 - t0)
            STATS["index_s"] += t1 - t0
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for c in range(n_chunks):
                    frags = _split_candidates(dev, load_chunk(c), lo,
                                              query_is_profile, pool)
                    spill(f"f{s_i}_{c}.npz", **frags)
            STATS["split_candidates_s"].append(time.perf_counter() - t1)
            del dev, table

        # the exact cross-split merge, a chunk at a time
        t0 = time.perf_counter()
        writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
        reslens = []
        for c in range(n_chunks):
            z = load_chunk(c)
            fz = [dict(np.load(os.path.join(tmpdir, f"f{s}_{c}.npz")))
                  for s in range(n_splits)]
            f_of = [np.concatenate([[0], np.cumsum(f["n_of"])]) for f in fz]
            e_of = [np.concatenate([[0], np.cumsum(f["e_of"])]) for f in fz]
            for r, qid in enumerate(chunk_range(c)):
                m = qmeta[qid]
                ids, diags, scores = (np.concatenate(
                    [f[name][f_of[s][r]:f_of[s][r + 1]]
                     for s, f in enumerate(fz)])
                    for name in ("ids", "diag", "sc"))
                exacts = {}
                for s, f in enumerate(fz):
                    for (i, d), v in zip(f["ek"][e_of[s][r]:e_of[s][r + 1]],
                                         f["ev"][e_of[s][r]:e_of[s][r + 1]]):
                        exacts[(int(i), int(d))] = int(v)

                def exact_fn(eids, ediags, _ex=exacts):
                    return np.array([_ex[(int(i), int(d))]
                                     for i, d in zip(eids, ediags)],
                                    np.int64)

                q_num = z["qnum"][z["no"][r]:z["no"][r + 1]].astype(np.int64)
                if query_is_profile:
                    prof = z["rows"][z["no"][r]:z["no"][r + 1]]
                else:
                    corr = z["corr"][z["no"][r]:z["no"][r + 1]]
                    prof = ungapped.sub_matrix[q_num] + corr[:, None]
                hits = finalize_query(
                    ids, diags, scores, par.max_seqs, par.min_ungapped_score,
                    m["ident"], exact_fn,
                    self_ungapped_score(prof.astype(np.int64), q_num))
                reslens.append(_write_hits(writer, par, treader, m["key"],
                                           m["qlen"], hits))
        writer.close()
        STATS["split_merge_s"] += time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    STATS["queries"] += nq
    STATS["hits"] += sum(reslens)
    _print_statistics(None, reslens, nq, par.max_seqs)
    return 0


def _split_candidates(dev, z, lo, query_is_profile, pool):
    """One chunk's candidate fragments against one split (dev holds its
    index, local ids from 0; lo the split's first target): per query the
    best candidate of each id (global ids ascending, u16 diagonals, capped
    scores) and the exact scores of the saturated ones, as arrays for the
    spill. The queries' posting-list lookups run in `pool` (random reads
    of the index's offsets, as stage-0's in _run_device); the chunk goes
    to the device in flushes of at most B_PAD queries and about
    H_CAP_FIXED expansions, as _run_device's."""
    out = dict(ids=[], diag=[], sc=[], ek=[], ev=[])
    batch, queries, budget = [], [], 0

    def flush():
        nonlocal batch, queries, budget
        if not batch:
            return
        STATS["flushes"] += 1
        for ids, diags, scores, exacts in dev.candidates_batch(batch,
                                                               queries):
            out["ids"].append(ids + lo)
            out["diag"].append(diags)
            out["sc"].append(scores)
            out["ek"].append(np.array([[i + lo, d] for (i, d) in exacts],
                                      np.int64).reshape(-1, 2))
            out["ev"].append(np.array(list(exacts.values()), np.int64))
        batch, queries, budget = [], [], 0

    def prepare(r):
        """Query r's (starts, counts, qpos, rows, corr) against the split."""
        codes = z["codes"][z["ko"][r]:z["ko"][r + 1]]
        qpos = z["qpos"][z["ko"][r]:z["ko"][r + 1]]
        st, ct = dev.index.lists(codes)
        nz = ct > 0
        rows = z["no"][r], z["no"][r + 1]
        if query_is_profile:
            return (st[nz].astype(np.int64), ct[nz].astype(np.int32),
                    qpos[nz], profile_rows(z["rows"][rows[0]:rows[1]]), None)
        return (st[nz].astype(np.int64), ct[nz].astype(np.int32), qpos[nz],
                None, z["corr"][rows[0]:rows[1]])

    for r, prep in enumerate(pool.map(prepare, range(len(z["k_of"])))):
        vol = int(prep[1].sum())
        if batch and (budget + vol > dev.H_CAP_FIXED
                      or len(batch) >= dev.B_PAD):
            flush()
        batch.append(prep)
        queries.append(z["qnum"][z["no"][r]:z["no"][r + 1]])
        budget += vol
    flush()
    return dict(
        ids=_cat(out["ids"], np.int64), diag=_cat(out["diag"], np.uint16),
        sc=_cat(out["sc"], np.int64),
        n_of=np.array([len(x) for x in out["ids"]], np.int64),
        ek=(np.concatenate(out["ek"]) if out["ek"]
            else np.zeros((0, 2), np.int64)),
        ev=_cat(out["ev"], np.int64),
        e_of=np.array([len(x) for x in out["ev"]], np.int64))


def _cat(arrays, dtype):
    return (np.concatenate(arrays).astype(dtype, copy=False) if arrays
            else np.zeros(0, dtype))


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


def _run_host(par, qreader, treader, qdb, matcher, query_is_profile,
              same_db, out_path, alpha):
    """Per-query host (numpy oracle) matching loop."""
    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    stats_acc = [0.0, 0, 0]
    reslens = []
    for qid in range(qreader.size):
        q_key = qreader.get_db_key(qid)
        identity_id = _identity_id(par, qreader, treader, same_db, q_key)
        if query_is_profile:
            p = parse_profile(qreader.get_data(qid))
            gen, rescore = profile_query(
                p, matcher.k, alpha, matcher.index.offsets_pat)
            hits = matcher.match(p.query_num.astype(np.int64), identity_id,
                                 diagonal_scoring=bool(par.diag_score),
                                 rescore_profile=rescore, generator=gen)
            q_len = float(p.length)
        else:
            hits = matcher.match(qdb.seq_num(qid), identity_id,
                                 diagonal_scoring=bool(par.diag_score))
            q_len = float(qreader.get_seq_len(qid))
        reslens.append(_write_hits(writer, par, treader, q_key, q_len,
                                   hits))
        stats_acc[0] += matcher.stats.kmers_per_pos
        stats_acc[1] += matcher.stats.db_matches
        stats_acc[2] += matcher.stats.double_matches
    writer.close()
    STATS["queries"] += qreader.size
    STATS["hits"] += sum(reslens)
    _print_statistics(stats_acc, reslens, qreader.size, par.max_seqs)
    return 0
