"""`kmermatcher` command: linear-time k-min-mer candidate pairs.

Reference: src/linclust/kmermatcher.cpp (setLinearFilterDefault :1085,
setKmerLengthAndAlphabet :2038). Linclust v1 (longest-center) path.
"""

import numpy as np

from ..cluster import kmermatcher as km
from ..data.reduced import get_reduced
from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.writer import DBWriter
from ..utils import log
from .common import open_seq_db


def _parse_mem_limit(text):
    t = str(text).strip().upper()
    if t in ("0", ""):
        return 0
    mult = 1
    if t[-1] in "KMGT":
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
                "T": 1 << 40}[t[-1]]
        t = t[:-1]
    return int(float(t) * mult)


def _memory_splits(par, seqs, kmer_per_seq):
    limit = _parse_mem_limit(par.split_memory_limit)
    if limit <= 0:
        return 1
    scale = par.kmer_per_seq_scale.aa
    total = sum(int(kmer_per_seq - 1 + scale * len(s)) + 1 for s in seqs)
    need = total * 32      # 4 int64 columns per entry
    return max(1, -(-need // limit))


def kmer_length_and_alphabet(par, residues: int):
    """setKmerLengthAndAlphabet for amino-acid DBs."""
    k = par.kmer_size
    alpha = par.alph_size.aa
    if k == 0:
        if par.min_seq_id + 0.001 >= 0.99:
            k, alpha = 14, 21
        elif par.min_seq_id + 0.001 >= 0.9:
            k, alpha = 14, 13
        else:
            k = max(10, int(np.log(np.float32(residues)) / np.log(8.7)))
            alpha = 13
    # standalone kmermatcher resets kmersPerSequence to the linear-filter
    # default (setLinearFilterDefault -> 0 -> 20); workflows pass it
    # explicitly (their serialized value, 21 by default)
    kmer_per_seq = par.kmer_per_seq if par.was_set("kmer_per_seq") else 20
    return k, alpha, kmer_per_seq


def kmermatcher(par, command):
    seq_path, out_path = par.filenames[:2]
    reader = open_seq_db(seq_path)
    # setLinearFilterDefault
    cov_thr = par.cov_thr if par.was_set("cov_thr") else 0.8
    mask = par.mask if par.was_set("mask") else 0

    if reader.base_type == dbt.DBTYPE_NUCLEOTIDES:
        return _kmermatcher_nucl(par, reader, out_path, cov_thr)

    k, alpha, kmer_per_seq = kmer_length_and_alphabet(
        par, reader.total_residues())
    log.info(f"kmermatcher: k = {k}, alphabet = {alpha}, "
             f"kmers/seq = {kmer_per_seq}")

    if alpha < 21:
        submat = get_reduced(par.sub_mat.aa, alpha, 2.0)
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    x_idx = submat.alphabet_size - 1

    seqs = [submat.encode(reader.get_seq(i)) for i in range(reader.size)]
    if mask:
        from ..ops.tantan import likelihood_ratio_matrix, mask_batch
        seqs, _ = mask_batch(seqs, likelihood_ratio_matrix(submat), x_idx,
                             par.mask_prob)

    # standalone default: no spaced k-mers (setLinearFilterDefault)
    spaced = bool(par.spaced_kmer_mode) if par.was_set("spaced_kmer_mode") \
        else False

    # --linclust-version 2 (the default) with adjacency and/or count-table
    # center swapping enabled takes the write-buffer chain dataflow
    # (kmermatcher.cpp:1501-1526); version 1 forces both off.
    include_adj = par.include_adjacency and par.linclust_version != 1
    include_ct = par.include_count_table and par.linclust_version != 1
    if include_adj or include_ct:
        from ..cluster import kmermatcher_chain as kmc
        from ..prefilter.kmer_index import pattern_offsets
        offsets, span = pattern_offsets(k, spaced)
        result = kmc.kmermatcher_v2(
            seqs, reader.keys, k, alpha - 1, x_idx, kmer_per_seq,
            par.kmer_per_seq_scale.aa, par.hash_shift, offsets, span,
            cov_thr, par.cov_mode, par.include_only_extendable,
            submat.sub_matrix, include_adj=include_adj,
            include_ct=include_ct, adj_iters=par.num_adjacency,
            ct_iters=par.num_count_table,
            count_scale=par.count_table_scale,
            max_key=int(max(reader.keys)) if reader.size else 0)
        writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
        written = set()
        for rep in sorted(result):
            lines = [f"{rep}\t0\t0\n"]
            for member, score, diag in result[rep]:
                lines.append(f"{member}\t{score}\t{diag}\n")
            writer.write(rep, "".join(lines).encode())
            written.add(rep)
        for i in range(reader.size):
            key = int(reader.get_db_key(i))
            if key not in written:
                writer.write(key, f"{key}\t0\t0\n".encode())
        writer.close()
        reader.close()
        return 0

    weights = None
    if par.weights:
        weights = {}
        for line in open(par.weights):
            parts = line.split()
            if len(parts) >= 2:
                weights[int(parts[0])] = float(parts[1])
    # memory-bounded hash-range splits (kmermatcher.cpp:1441-1470
    # setupKmerSplits): each split holds complete k-mer groups, so the
    # merged pair union is identical to the unsplit run
    n_splits = _memory_splits(par, seqs, kmer_per_seq)
    parts = []
    step = 65536 // n_splits
    for si in range(n_splits):
        lo = si * step
        hi = 65535 if si == n_splits - 1 else (si + 1) * step - 1
        parts.append(km.build_pairs(
            seqs, reader.keys, k, alpha - 1, x_idx, kmer_per_seq,
            par.kmer_per_seq_scale.aa, par.hash_shift, cov_thr,
            par.cov_mode, par.include_only_extendable, spaced,
            weights=weights, weight_thr=par.weight_thr,
            hash_range=None if n_splits == 1 else (lo, hi)))
    rep_k = np.concatenate([p[0] for p in parts])
    mem_k = np.concatenate([p[1] for p in parts])
    diags = np.concatenate([p[2] for p in parts])
    if n_splits > 1:
        log.info(f"Processed k-mers in {n_splits} hash-range splits")
    log.info(f"{len(rep_k)} candidate pairs")

    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    written = km.write_result(writer, rep_k, mem_k, diags)
    # sequences that did not become a written representative get a self-only
    # entry (kmermatcher.cpp:1404-1423)
    for i in range(reader.size):
        key = int(reader.get_db_key(i))
        if key not in written:
            writer.write(key, f"{key}\t0\t0\n".encode())
    writer.close()
    reader.close()
    return 0


def _kmermatcher_nucl(par, reader, out_path, cov_thr):
    """Nucleotide path: reverse-complement-canonical 2-bit k-mers, output
    typed DBTYPE_PREFILTER_REV_RES with negative scores flagging reversed
    matches (kmermatcher.cpp:166-203,631-661,1360,2039-2046)."""
    k = par.kmer_size
    if k == 0:
        k = max(17, int(np.log(np.float32(reader.total_residues()))
                        / np.log(4.0)))
    kmer_per_seq = par.kmer_per_seq if par.was_set("kmer_per_seq") else 60
    log.info(f"kmermatcher (nucl): k = {k}, kmers/seq = {kmer_per_seq}")
    submat = get_submat(par.sub_mat.nucl, 1.0, 0.0)
    x_idx = submat.alphabet_size - 1
    seqs = [submat.encode(reader.get_seq(i)) for i in range(reader.size)]
    if par.was_set("mask") and par.mask:
        from ..ops.tantan import likelihood_ratio_matrix, mask_batch
        seqs, _ = mask_batch(seqs, likelihood_ratio_matrix(submat), x_idx,
                             par.mask_prob)
    rep_k, mem_k, diags, revs = km.build_pairs_nucl(
        seqs, reader.keys, k, kmer_per_seq, par.kmer_per_seq_scale.nucl,
        par.hash_shift, cov_thr, par.cov_mode,
        par.include_only_extendable, adjust_len=bool(par.adjust_kmer_len))
    log.info(f"{len(rep_k)} candidate pairs")
    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_REV_RES)
    written = km.write_result(writer, rep_k, mem_k, diags, revs)
    for i in range(reader.size):
        key = int(reader.get_db_key(i))
        if key not in written:
            writer.write(key, f"{key}\t0\t0\n".encode())
    writer.close()
    reader.close()
    return 0
