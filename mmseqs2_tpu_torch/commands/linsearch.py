"""Linsearch subsystem: kmerindexdb / createlinindex / kmersearch /
linsearch / easy-linsearch.

Reference: src/linclust/kmerindexdb.cpp (k-min-mer index build,
LinsearchIndexReader::pickCenterKmer keeps exactly ONE entry — the first in
(kmer, id, pos) order — per distinct k-mer, LinsearchIndexReader.cpp:21-61),
src/linclust/kmersearch.cpp (query k-min-mer extraction, sorted merge-join
searchInIndex :301-431, per-target grouped output writeResult :44-117 with
per-hit match count and majority diagonal), src/workflow/Linsearch.cpp +
data/workflow/linsearch.sh (kmersearch -> rescorediagonal filter -> align in
the target-centric direction -> swapresults).

Amino-acid path; k-mer selection reuses the parity-tested kmermatcher
machinery (cluster/kmermatcher.py select_kmers).

Port of mmseqs2_tpu/commands/linsearch.py: the index, kmersearch and the
rescore are host code; the align step runs sw_multi on the card.
"""

import json
import os

import numpy as np

from ..cluster import kmermatcher as km
from ..data.reduced import get_reduced
from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..prefilter.kmer_index import pattern_offsets
from ..utils import log
from ..workflow.engine import Workflow
from .common import open_seq_db
from .kmermatcher import kmer_length_and_alphabet

LINIDX_VERSION = "mmseqs2-tpu-linidx-1"
K_VERSION, K_META, K_KMERS, K_IDS, K_POS, K_LENS = 0, 1, 2, 3, 4, 5


def _extract_sorted(reader, submat, k, alpha, kmer_per_seq, par, spaced):
    """Per-sequence k-min-mer selection, sorted by (kmer, id, pos) — the
    extractKmerAndSort dataflow (no whole-sequence hash entries)."""
    x_idx = submat.alphabet_size - 1
    offsets, span = pattern_offsets(k, spaced)
    ks, ids, poss, lens = [], [], [], []
    for lid in range(reader.size):
        seq = submat.encode(reader.get_seq(lid))
        considered = int(kmer_per_seq - 1
                         + par.kmer_per_seq_scale.aa * len(seq))
        kmers, pos, _ = km.select_kmers(seq, k, alpha - 1, x_idx, considered,
                                        par.hash_shift, offsets, span)
        key = int(reader.get_db_key(lid))
        ks.append(kmers)
        ids.append(np.full(len(kmers), key, np.int64))
        poss.append(pos)
        lens.append(np.full(len(kmers), len(seq), np.int64))
    kmer = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
    sid = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    pos = np.concatenate(poss) if poss else np.zeros(0, np.int64)
    slen = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    order = np.lexsort((pos, sid, kmer))
    return kmer[order], sid[order], pos[order], slen[order]


def _linidx_params(par, residues):
    k, alpha, kmer_per_seq = kmer_length_and_alphabet(par, residues)
    if alpha < 21:
        submat = get_reduced(par.sub_mat.aa, alpha, 2.0)
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    spaced = bool(par.spaced_kmer_mode) if par.was_set("spaced_kmer_mode") \
        else False
    return k, alpha, kmer_per_seq, submat, spaced


def kmerindexdb(par, command):
    """Persist the sorted one-entry-per-kmer target table."""
    seq_path, out_path = par.filenames[:2]
    reader = open_seq_db(seq_path)
    k, alpha, kmer_per_seq, submat, spaced = _linidx_params(
        par, reader.total_residues())
    log.info(f"kmerindexdb: k = {k}, alphabet = {alpha}, "
             f"kmers/seq = {kmer_per_seq}")
    kmer, sid, pos, slen = _extract_sorted(reader, submat, k, alpha,
                                           kmer_per_seq, par, spaced)
    # pickCenterKmer: first entry per distinct kmer
    if len(kmer):
        first = np.ones(len(kmer), bool)
        first[1:] = kmer[1:] != kmer[:-1]
        kmer, sid, pos, slen = (kmer[first], sid[first], pos[first],
                                slen[first])
    w = DBWriter(out_path, dbt.DBTYPE_INDEX_DB)
    w.write(K_VERSION, LINIDX_VERSION.encode())
    meta = dict(k=k, alpha=alpha, kmer_per_seq=kmer_per_seq,
                spaced=int(spaced), hash_shift=par.hash_shift,
                seq_type=int(reader.base_type), n_entries=len(kmer))
    w.write(K_META, json.dumps(meta).encode())
    w.write(K_KMERS, kmer.astype(np.uint64).tobytes(), add_null=False)
    w.write(K_IDS, sid.astype(np.int64).tobytes(), add_null=False)
    w.write(K_POS, pos.astype(np.int64).tobytes(), add_null=False)
    w.write(K_LENS, slen.astype(np.int64).tobytes(), add_null=False)
    w.close()
    log.info(f"Wrote {len(kmer)} index k-mers")
    reader.close()
    return 0


def createlinindex(par, command):
    """Workflow wrapper: builds <seqDB>.linidx."""
    seq_path = par.filenames[0]
    par.filenames = [seq_path, seq_path + ".linidx"]
    return kmerindexdb(par, command)


def load_linidx(path):
    with DBReader(path) as r:
        ver = r.get_data(r.get_id(K_VERSION)).decode()
        if ver != LINIDX_VERSION:
            raise ValueError(f"incompatible linsearch index {ver!r}")
        meta = json.loads(r.get_data(r.get_id(K_META)))
        kmer = np.frombuffer(r.get_data_raw(r.get_id(K_KMERS)), np.uint64)
        sid = np.frombuffer(r.get_data_raw(r.get_id(K_IDS)), np.int64)
        pos = np.frombuffer(r.get_data_raw(r.get_id(K_POS)), np.int64)
        slen = np.frombuffer(r.get_data_raw(r.get_id(K_LENS)), np.int64)
    return meta, kmer, sid, pos, slen


def kmersearch(par, command):
    query_path, idx_path, out_path = par.filenames[:3]
    meta, t_kmer, t_id, t_pos, t_len = load_linidx(idx_path)
    reader = open_seq_db(query_path)
    k = meta["k"]
    alpha = meta["alpha"]
    # keep the index's letter mapping (kmerindexdb builds at 2-bit scale;
    # the reduction depends only on the probability matrix)
    if alpha < 21:
        submat = get_reduced(par.sub_mat.aa, alpha, 2.0)
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    par.set("hash_shift", meta["hash_shift"])
    kmer_per_seq = meta["kmer_per_seq"]
    spaced = bool(meta["spaced"])
    log.info(f"kmersearch: k = {k}, alphabet = {alpha}")
    q_kmer, q_id, q_pos, q_len = _extract_sorted(reader, submat, k, alpha,
                                                 kmer_per_seq, par, spaced)

    # merge-join (searchInIndex): one index entry per kmer pairs with every
    # query occurrence of that kmer
    ti = np.searchsorted(t_kmer, q_kmer)
    ti = np.minimum(ti, max(len(t_kmer) - 1, 0))
    hit = len(t_kmer) > 0 and len(q_kmer) > 0
    matched = (t_kmer[ti] == q_kmer) if hit else np.zeros(0, bool)
    qi = np.nonzero(matched)[0]
    ti = ti[matched]
    # --result-direction: TARGET (1, default) groups by target id with
    # hit = query id and diagonal targetPos - queryPos; QUERY (0) swaps
    # roles (kmersearch.cpp:301-320)
    if par.result_direction == 1:
        rep = t_id[ti]
        hid = q_id[qi]
        diag = (t_pos[ti] - q_pos[qi]).astype(np.int64)
    else:
        rep = q_id[qi]
        hid = t_id[ti]
        diag = (q_pos[qi] - t_pos[ti]).astype(np.int64)
    order = np.lexsort((diag, hid, rep))
    rep, hid, diag = rep[order], hid[order], diag[order]

    writer = DBWriter(out_path, dbt.DBTYPE_PREFILTER_RES)
    n = len(rep)
    i = 0
    while i < n:
        j = i
        lines = []
        while j < n and rep[j] == rep[i]:
            # one run per (target, query): count matches, majority diagonal
            r0 = j
            while j < n and rep[j] == rep[i] and hid[j] == hid[r0]:
                j += 1
            run_d = diag[r0:j]
            best_cnt, best_d, cnt = 0, int(run_d[0]), 0
            prev = None
            for d in run_d:
                cnt = cnt + 1 if d == prev else 1
                if cnt > best_cnt:
                    best_cnt, best_d = cnt, int(d)
                prev = d
            lines.append(f"{hid[r0]}\t{j - r0}\t{np.int16(best_d)}\n")
        writer.write(int(rep[i]), "".join(lines).encode())
        i = j
    writer.close()
    reader.close()
    return 0


def linsearch(par, command):
    """linsearch workflow (linsearch.sh, protein path)."""
    query, target, out, tmp_dir = par.filenames[:4]
    idx = target + ".linidx"
    wf = Workflow(tmp_dir)
    usable = False
    if os.path.exists(idx + ".dbtype"):
        try:
            load_linidx(idx)
            usable = True
        except Exception:
            log.warning(f"{idx} is not a compatible linsearch index; "
                        "building one in the tmp directory")
            idx = wf.path("linidx")
    if not usable:
        if not os.path.exists(idx + ".dbtype"):
            wf.step(idx, "kmerindexdb", [target, idx], par)
    pref = wf.path("pref")
    wf.step(pref, "kmersearch", [query, idx, pref], par)
    resultdb = pref
    # FILTER=1 (Linsearch.cpp:112-123): target-centric ungapped rescore at
    # cov >= 0.9, then drop pref lines absent from the surviving set
    orig_cov_mode, orig_cov = par.cov_mode, par.cov_thr
    if not par.was_set("cov_mode"):
        par.set("cov_mode", 1)            # COV_MODE_TARGET
    par.set("cov_thr", max(par.cov_thr, 0.9))
    par.set("rescore_mode", 2)            # RESCORE_MODE_ALIGNMENT
    wf.step(wf.path("reverse_ungapaln"), "rescorediagonal",
            [target, query, resultdb, wf.path("reverse_ungapaln")], par)
    par.set("cov_mode", orig_cov_mode)
    par.set("cov_thr", orig_cov)
    wf.step(wf.path("pref_filter"), "filterdb",
            [pref, wf.path("pref_filter"), "--filter-file",
             wf.path("reverse_ungapaln"), "--positive-filter", "0"])
    resultdb = wf.path("pref_filter")
    orig_eval = par.evalue
    par.set("evalue", 100000.0)
    if not par.was_set("alignment_mode"):
        par.set("alignment_mode", 2)       # SCORE_COV (linsearch default)
    wf.step(wf.path("reverse_aln"), "align",
            [target, query, resultdb, wf.path("reverse_aln")], par)
    par.set("evalue", orig_eval)
    wf.step(out, "swapresults",
            [target, query, wf.path("reverse_aln"), out], par)
    wf.cleanup(par.remove_tmp_files)
    return 0


def easy_linsearch(par, command):
    """FASTA in, BLAST-tab out."""
    q_fa, t_fa, out_file, tmp_dir = par.filenames[:4]
    wf = Workflow(tmp_dir)

    def db_of(path, name):
        if os.path.exists(path + ".dbtype"):
            return path
        wf.step(wf.path(name), "createdb", [path, wf.path(name)], par)
        return wf.path(name)

    qdb = db_of(q_fa, "query")
    tdb = db_of(t_fa, "target")
    res = wf.path("result")
    par.filenames = [qdb, tdb, res, wf.path("lin_tmp")]
    linsearch(par, command)
    from ..params import Params
    from ..registry import get_command
    cmd = get_command("convertalis")
    sub = Params().parse([qdb, tdb, res, out_file], cmd, 4, 4)
    for attr in par._was_set:
        if attr not in sub._was_set:
            sub.set(attr, getattr(par, attr))
    cmd.load()(sub, cmd)
    wf.cleanup(par.remove_tmp_files)
    return 0
