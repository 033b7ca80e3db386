"""Alignment-family extras: alignall, transitivealign, pairaln.

Port of mmseqs2_tpu/commands/align_extra.py. References:
src/util/alignall.cpp (all-vs-all SW within result sets),
src/util/transitivealign.cpp (A->C inference through a center B with
backtrace composition + rescoring, then a swap-regroup to per-query
entries), src/util/pairaln.cpp (best-hit pairing per file-number).

alignall sends the member pairs of a block of sets through one
Aligner.align_batch (the `sw_multi` kernel on the card), where the JAX
command calls align_query once a member; a pair's alignment does not
depend on its batch, so the bytes are the same. The rest is host code.
"""

from collections import defaultdict

import numpy as np

from ..align import util as autil
from ..align.aligner import Aligner, sort_results
from ..db import dbtype as dbt
from ..db.reader import DBReader, open_header_db
from ..db.writer import DBWriter
from ..ops.evalue import EvalueComputation
from ..utils import log
from .align_cmd import check_criteria, init_sw_mode
from .common import EncodedDB, fast_atoi, get_sub_mat, open_seq_db
from .expandaln import Rec, parse_records, translate_result

# alignall: member pairs (candidates of every member of a block of sets)
# that go through one align_batch
ALIGNALL_PAIRS = 1 << 16

# alignall's counters, summed until reset_stats(): sets, pairs aligned,
# align_batch calls
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(sets=0, pairs=0, batches=0)


reset_stats()


def alignall(par, command):
    """All-vs-all SW inside each result entry's member set
    (reference src/util/alignall.cpp): output entry <setKey> holds
    "queryKey\\t<record>" lines for every passing ordered member pair."""
    tdb_path, res_path, out_path = par.filenames[:3]
    if par.add_backtrace:
        par.set("alignment_mode", 3)
    sw_mode = init_sw_mode(par.alignment_mode, par.cov_thr, par.min_seq_id)
    treader = open_seq_db(tdb_path)
    submat = get_sub_mat(par)
    tdb = EncodedDB(treader, submat)
    is_nucl = treader.base_type == dbt.DBTYPE_NUCLEOTIDES
    go = par.gap_open.nucl if is_nucl else par.gap_open.aa
    ge = par.gap_extend.nucl if is_nucl else par.gap_extend.aa
    evaluer = EvalueComputation(treader.total_residues(), submat, go, ge)
    aligner = Aligner(submat, go, ge, evaluer, par.comp_bias_corr,
                      par.comp_bias_corr_scale)
    res = DBReader(res_path)

    def flush(w, block):
        jobs = [job for _, members in block for _, job in members]
        results = iter(aligner.align_batch(
            jobs, sw_mode, par.cov_mode, par.cov_thr, par.evalue,
            par.seq_id_mode) if jobs else [])
        STATS["batches"] += bool(jobs)
        for set_key, members in block:
            out_lines = []
            for qk, job in members:
                for r, is_id in zip(next(results), job[4]):
                    if check_criteria(r, is_id, par.evalue, par.min_seq_id,
                                      par.min_aln_len, par.cov_mode,
                                      par.cov_thr):
                        out_lines.append(
                            f"{qk}\t" + r.to_line(par.add_backtrace))
            w.write(set_key, "".join(out_lines).encode())
            STATS["sets"] += 1

    with DBWriter(out_path, dbt.DBTYPE_GENERIC_DB,
                  compressed=bool(par.compressed)) as w:
        block, n_pairs = [], 0
        for i in (int(x) for x in np.argsort(res.offsets, kind="stable")):
            set_key = res.get_db_key(i)
            keys = []
            for line in res.get_data(i).split(b"\n"):
                if line:
                    keys.append(fast_atoi(line.split(b"\t")[0]))
            ids = []
            for k in keys:
                tid = treader.get_id(k)
                if tid < 0:
                    log.die(f"Invalid query key {k} in result entry "
                            f"{set_key}.")
                ids.append(tid)
            members = []
            for qk, qid in zip(keys, ids):
                ctx = aligner.init_query(tdb.seq_num(qid))
                q_len = tdb.seq_len(qid)
                cand = [(tk, tid) for tk, tid in zip(keys, ids)
                        if autil.can_be_covered(par.cov_thr, par.cov_mode,
                                                float(q_len),
                                                float(tdb.seq_len(tid)))]
                idents = [par.include_identity and tid == qid
                          for _, tid in cand]
                members.append((qk, (
                    ctx, [tk for tk, _ in cand],
                    [tdb.seq_num(tid) for _, tid in cand],
                    [tdb.seq_len(tid) for _, tid in cand], idents)))
                n_pairs += len(cand)
            STATS["pairs"] += sum(len(job[1]) for _, job in members)
            block.append((set_key, members))
            if n_pairs >= ALIGNALL_PAIRS:
                flush(w, block)
                block, n_pairs = [], 0
        if block:
            flush(w, block)
    res.close()
    return 0


def _swap_rec(r: Rec, evaluer) -> Rec:
    """Matcher::result_t::swapResult (Matcher.h:97-119)."""
    s = Rec()
    raw = evaluer.compute_raw_score_from_bit_score(r.score)
    s.db_key = r.db_key
    s.score = r.score
    s.seq_id = r.seq_id
    s.eval = evaluer.compute_evalue(raw, r.db_len)
    s.q_start, s.q_end, s.q_len = r.db_start, r.db_end, r.db_len
    s.db_start, s.db_end, s.db_len = r.q_start, r.q_end, r.q_len
    s.backtrace = r.backtrace.translate(str.maketrans("ID", "DI"))
    s.aln_length = r.aln_length
    s.qcov, s.dbcov = r.dbcov, r.qcov
    return s


def transitivealign(par, command):
    """Infer A->C alignments through shared centers B
    (reference src/util/transitivealign.cpp): per entry B, swap B->A to
    A->B, compose with each B->C, rescore along the backtrace, then
    regroup all "A\\t<record>" lines into per-A entries."""
    seq_path, aln_path, out_path = par.filenames[:3]
    seqs = DBReader(seq_path)
    submat = get_sub_mat(par)
    enc = submat.make_aa2num_table()
    go, ge = par.gap_open.aa, par.gap_extend.aa
    evaluer = EvalueComputation(seqs.total_residues(), submat, go, ge)
    aln = DBReader(aln_path)
    groups = defaultdict(list)
    for i in (int(x) for x in np.argsort(aln.offsets, kind="stable")):
        aln_key = aln.get_db_key(i)
        results = parse_records(aln.get_data(i))
        for rec_i in results:
            qid = seqs.get_id(rec_i.db_key)
            if qid < 0:
                log.die(f"Invalid query key {rec_i.db_key} in alignment "
                        f"entry {aln_key}.")
            query_key = rec_i.db_key
            swapped = _swap_rec(rec_i, evaluer)
            qseq = seqs.get_data(qid)
            if query_key == aln_key:
                for rec_j in results:
                    groups[query_key].append(rec_j.to_line(True))
                continue
            out_results = []
            for rec_j in results:
                tid = seqs.get_id(rec_j.db_key)
                if tid < 0:
                    log.die(f"Invalid target key {rec_j.db_key} in "
                            f"alignment entry {aln_key}.")
                tseq = seqs.get_data(tid)
                if not autil.can_be_covered(par.cov_thr, par.cov_mode,
                                            float(swapped.q_len),
                                            float(rec_j.db_len)):
                    continue
                is_identity = qid == tid and par.include_identity
                if rec_i.db_key == rec_j.db_key:
                    # local substitution distance along the full diagonal
                    # (DistanceCalculator::computeSubstitutionDistance)
                    q_arr = enc[np.frombuffer(qseq[:rec_i.db_len],
                                              np.uint8)].astype(np.int64)
                    t_arr = enc[np.frombuffer(tseq[:rec_i.db_len],
                                              np.uint8)].astype(np.int64)
                    vals = submat.sub_matrix[q_arr, t_arr].astype(np.int64)
                    run = 0
                    best = 0
                    for v in vals:
                        run = max(0, run + int(v))
                        best = max(best, run)
                    r = Rec()
                    r.db_key = rec_j.db_key
                    r.db_len = rec_j.db_len
                    r.q_len = rec_j.db_len
                    r.score = int(evaluer.compute_bit_score(best))
                    r.eval = evaluer.compute_evalue(best, rec_j.db_len)
                    r.q_start = r.db_start = 0
                    r.q_end = r.db_end = rec_j.db_len - 1
                    r.seq_id = 1.0
                    r.aln_length = rec_j.db_len
                    r.backtrace = "M" * rec_j.db_len
                    r.qcov = r.dbcov = 1.0
                else:
                    r = translate_result(swapped, rec_j)
                    autil.rescore_backtrace(qseq, tseq, enc,
                                            submat.sub_matrix, evaluer,
                                            go, ge, r)
                if check_criteria(r, is_identity, par.evalue,
                                  par.min_seq_id, par.min_aln_len,
                                  par.cov_mode, par.cov_thr):
                    out_results.append(r)
            sort_results(out_results)
            groups[query_key].extend(r.to_line(True) for r in out_results)
    with DBWriter(out_path, aln.base_type,
                  compressed=bool(par.compressed)) as w:
        for key in sorted(groups):
            if groups[key]:
                w.write(key, "".join(groups[key]).encode())
    aln.close()
    seqs.close()
    return 0


# -- pairaln -------------------------------------------------------------------

_UINT_MAX = 0xFFFFFFFF


def _uniprot_structured_number(acc: str) -> int:
    """UniProtConverter::toStructuredNumber (pairaln.cpp:28-124): map a
    UniProt-style accession to a dense integer so chain partners can be
    matched by accession proximity."""
    if acc.startswith("UniRef"):
        parts = acc.split("_")
        if len(parts) > 1:
            acc = parts[1]
    if "-" in acc:
        acc = acc[:acc.find("-")]
    if not acc:
        return 0
    n = len(acc)
    first = acc[0].upper()

    def digit(c):
        return ord(c) - 48 if "0" <= c <= "9" else -1

    def alpha(c):
        return ord(c) - 65 if "A" <= c <= "Z" else -1

    def alnum(c):
        if "0" <= c <= "9":
            return ord(c) - 48
        if "A" <= c <= "Z":
            return ord(c) - 65 + 10
        return -1

    def opq(c):
        return {"O": 0, "P": 1, "Q": 2}.get(c, -1)

    def anrz(c):
        if "A" <= c <= "N":
            return ord(c) - 65
        if "R" <= c <= "Z":
            return ord(c) - 65 - 3
        return -1

    if n == 6 and first in "OPQ":
        number, mult = 0, 1
        for i in range(5, -1, -1):
            c = acc[i].upper()
            if i == 0:
                v, radix = opq(c), 3
            elif i in (1, 5):
                v, radix = digit(c), 10
            else:
                v, radix = alnum(c), 36
            if v == -1:
                return 0
            number += v * mult
            mult *= radix
        return number
    if n in (6, 10):
        number, mult = 0, 1
        for i in range(n - 1, -1, -1):
            c = acc[i].upper()
            if i == 0:
                v, radix = anrz(c), 23
            elif i in (1, 5, 9):
                v, radix = digit(c), 10
            elif i in (2, 6):
                v, radix = alpha(c), 26
            elif i in (3, 4, 7, 8):
                v, radix = alnum(c), 36
            else:
                return 0
            if v == -1:
                return 0
            number += v * mult
            mult *= radix
        return number
    if acc[:3] == "UPI":
        try:
            return 10 ** 15 + int(acc[3:], 16)
        except ValueError:
            return 0
    return 0


def _dummy_pair_line(db_key: int, has_backtrace: bool) -> str:
    """Matcher::result_t emptyResult (pairaln.cpp:255-256) serialized by
    resultToBuffer: qStartPos/dbStartPos are UINT_MAX stored in int fields,
    printed as -1."""
    line = f"{db_key}\t0\t0.000\t0.000E+00\t-1\t0\t0\t-1\t0\t0"
    if has_backtrace:
        line += "\t1M"
    return line + "\n"


def _find_nearest_partner(num: int, nums_sorted) -> int:
    """findNearestPartner (pairaln.cpp:141-179): index of the entry with the
    closest structured accession number (lower_bound + previous)."""
    import bisect
    if not nums_sorted:
        return -1
    it = bisect.bisect_left(nums_sorted, num)
    best, best_dist = -1, None
    if it < len(nums_sorted):
        best, best_dist = it, abs(nums_sorted[it] - num)
    if it > 0:
        d = abs(num - nums_sorted[it - 1])
        if best_dist is None or d < best_dist:
            best = it - 1
    return best


def pairaln(par, command):
    """Pair aligned sequences by file number and species
    (reference src/util/pairaln.cpp:196-476). Queries sharing a .lookup
    file number form a chain group; hits are paired per target taxon —
    top-hit mode emits the best hit per pairable taxon in taxon order,
    proximity mode matches partners by UniProt accession closeness."""
    from ..taxonomy.ncbi import MappingReader

    qdb_path, tdb_path, aln_path, out_path = par.filenames[:4]
    q = DBReader(qdb_path)
    lookup = q.read_lookup()
    if not lookup:
        log.die(f"Missing lookup file {qdb_path}.lookup")
    # USE_LOOKUP_REV sorts the lookup by accession (DBReader.cpp readLookup),
    # so group members are iterated in accession order (pairaln.cpp:200-211)
    file_to_keys = defaultdict(list)
    for key, (acc, file_number) in sorted(lookup.items(),
                                          key=lambda kv: kv[1][0]):
        file_to_keys[file_number].append(key)
    mapping = MappingReader(tdb_path)
    aln = DBReader(aln_path)
    header_acc = {}
    if par.pairfilter == 1:  # PAIRALN_FILTER_PROXIMITY
        from ..db.fasta import parse_fasta_header
        hdr = open_header_db(tdb_path)
        for i in range(len(hdr)):
            data = hdr.get_data(i).rstrip(b"\x00")
            header_acc[hdr.get_db_key(i)] = parse_fasta_header(
                data).decode("utf-8", "replace")
        hdr.close()

    # hasBacktrace and minResultDbKey are thread-scoped in the reference and
    # never reset between file groups (pairaln.cpp:252-254) — single-thread
    # semantics carry them across groups
    has_backtrace = False
    min_db_key = _UINT_MAX
    with DBWriter(out_path, aln.base_type,
                  compressed=bool(par.compressed)) as w:
        for file_number in sorted(file_to_keys):
            keys = file_to_keys[file_number]
            per_query = []
            # first pass: parse + count how many queries hit each taxon
            taxon_count = defaultdict(int)
            for key in keys:
                idx = aln.get_id(key)
                if idx < 0:
                    log.die(f"Missing alignment result for query key "
                            f"{key}.")
                recs = []
                for line in aln.get_data(idx).split(b"\n"):
                    if not line:
                        continue
                    parts = line.split(b"\t")
                    taxon = int(mapping.lookup(int(parts[0])))
                    recs.append((taxon, line, int(parts[0])))
                    has_backtrace = has_backtrace or len(parts) > 10
                    min_db_key = min(min_db_key, int(parts[0]))
                # stable sort by taxon keeps best-hit-first within taxon
                recs.sort(key=lambda r: r[0])
                for taxon in {r[0] for r in recs}:
                    taxon_count[taxon] += 1
                per_query.append(recs)
            threshold = (1 if par.pairmode == 0 else len(keys) - 1)
            taxon_to_pair = sorted(t for t, c in taxon_count.items()
                                   if c > threshold)
            if par.pairfilter == 1:
                _pairaln_proximity(par, w, keys, per_query, header_acc,
                                   has_backtrace, min_db_key)
                continue
            for key, recs in zip(keys, per_query):
                out = []
                start = 0
                for taxon_in_list in taxon_to_pair:
                    found = False
                    for ri in range(start, len(recs)):
                        if recs[ri][0] != taxon_in_list:
                            continue
                        found = True
                        out.append(recs[ri][1].decode() + "\n")
                        start = ri + 1
                        break
                    if not found and par.pairdummymode == 1:
                        out.append(_dummy_pair_line(min_db_key,
                                                    has_backtrace))
                w.write(key, "".join(out).encode())
    aln.close()
    q.close()
    return 0


def _pairaln_proximity(par, w, keys, per_query, header_acc,
                       has_backtrace, min_db_key):
    """Proximity pairing (pairaln.cpp:309-409): for every hit of the first
    chain, greedily pick the accession-nearest partner in each other chain;
    keep the set if partners lie within --pairing-prox-dist of a member."""
    # annotate each record with its structured accession number and sort
    ann = []
    for recs in per_query:
        rows = []
        for taxon, line, db_key in recs:
            num = _uniprot_structured_number(header_acc.get(db_key, ""))
            rows.append((num, line))
        rows.sort(key=lambda r: r[0])
        ann.append(rows)
    outputs = [[] for _ in keys]
    if ann:
        nums_per = [[r[0] for r in rows] for rows in ann]
        for num0, line0 in ann[0]:
            compatible = [(num0, line0)]
            fills = [line0]
            compatible_size = 1
            for i in range(1, len(ann)):
                pi = _find_nearest_partner(num0, nums_per[i])
                if pi < 0:
                    # not found: dummy only with --pairing-dummy-mode 1
                    # (pairaln.cpp:361-365 leaves DB_KEY_INVALID otherwise,
                    # skipped at output time, pairaln.cpp:394-398)
                    fills.append("dummy" if par.pairdummymode == 1
                                 else None)
                    continue
                cand_num = nums_per[i][pi]
                ok = any(abs(cand_num - n) <=
                         par.pair_proximity_distance
                         for n, _l in compatible)
                if ok:
                    compatible.append((cand_num, ann[i][pi][1]))
                    fills.append(ann[i][pi][1])
                    compatible_size += 1
                else:
                    # incompatible: emptyResult is written unconditionally
                    # (pairaln.cpp:384-386: dbKey=minResultDbKey != INVALID)
                    fills.append("dummy")
            if ((par.pairmode == 1 and compatible_size != len(ann))
                    or compatible_size == 1):
                continue
            for i, line in enumerate(fills):
                if line is None:
                    continue
                if line == "dummy":
                    outputs[i].append(
                        _dummy_pair_line(min_db_key, has_backtrace))
                    continue
                outputs[i].append(line.decode() + "\n")
    for key, out in zip(keys, outputs):
        w.write(key, "".join(out).encode())


# -- alignbykmer ----------------------------------------------------------------


def alignbykmer(par, command):
    """Fast k-mer-anchored approximate aligner
    (reference src/util/alignbykmer.cpp:21-519): shared spaced k-mers are
    chained into diagonal stretches, stretches are chained by a sparse DP,
    transition points between stretches are refined by a 1-D rescan, and the
    final chain is emitted as an M/I/D backtrace with a chain score.

    Stale-buffer fidelity: stretcheVec[0] / dpMatrixRow[0] are read
    UNINITIALIZED when a target shares <2 k-mer diagonals with the query
    (alignbykmer.cpp:342-348 with stretcheSize == 0); the reference arrays
    persist per thread across targets, so we keep them as run-level state
    (zero-filled at start, matching fresh calloc'd pages).
    """
    from ..prefilter.kmer_index import extract_kmers, pattern_offsets

    q_path, t_path, res_path, out_path = par.filenames[:4]
    treader = open_seq_db(t_path)
    same_db = (q_path == t_path)
    qreader = treader if same_db else open_seq_db(q_path)
    is_nucl = qreader.base_type == dbt.DBTYPE_NUCLEOTIDES
    if is_nucl:
        alpha = 5
        spaced = bool(par.spaced_kmer_mode) if par.was_set(
            "spaced_kmer_mode") else False
        k = par.kmer_size if par.was_set("kmer_size") else 9
        submat = get_sub_mat(par, nucl=True, bit_factor=1.0)
        go, ge = par.gap_open.nucl, par.gap_extend.nucl
    else:
        alpha = 21
        spaced = bool(par.spaced_kmer_mode)
        k = par.kmer_size if par.was_set("kmer_size") else 4
        submat = get_sub_mat(par)
        go, ge = par.gap_open.aa, par.gap_extend.aa
    offsets, span = pattern_offsets(k, spaced, par.spaced_kmer_pattern)
    qdb = EncodedDB(qreader, submat)
    tdb = qdb if same_db else EncodedDB(treader, submat)
    sub = submat.sub_matrix
    evaluer = EvalueComputation(treader.total_residues(), submat, go, ge)
    res = DBReader(res_path)

    # persistent "stale" state (see docstring)
    stale_stretch = [0, 0, 0, 0, 0]   # i_start, i_end, j_start, j_end, cnt
    stretche_vec = []                 # sorted prefix is live, rest stale
    # Sequence::numSequence buffers persist per thread; reads past the
    # current L see the previous sequence's residues (Sequence.h mapSequence
    # overwrites only [0, L)) — emulated with rolling buffers
    max_len = max(par.max_seq_len + 1, 1)
    qbuf = np.zeros(max_len, dtype=np.uint8)
    tbuf = np.zeros(max_len, dtype=np.uint8)

    with DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES,
                  compressed=bool(par.compressed)) as w:
        for rid in (int(x) for x in np.argsort(res.offsets, kind="stable")):
            query_key = res.get_db_key(rid)
            qid = qreader.get_id(query_key)
            if qid < 0:
                log.die(f"Invalid query key {query_key}.")
            qs = qdb.seq_num(qid)
            qlen = len(qs)
            qbuf[:qlen] = qs
            qseq = qbuf
            kidx, kpos, _ = extract_kmers(qs, offsets, span, alpha, -1)
            # the reference truncates Indexer::int2index to unsigned short
            # (alignbykmer.cpp:208,236) — k-mers collide modulo 65536, kept
            # for byte parity
            qpos_lookup = {}
            for x, p in zip(kidx.tolist(), kpos.tolist()):
                x &= 0xFFFF
                if x not in qpos_lookup:
                    qpos_lookup[x] = p
            out = []
            for line in res.get_data(rid).split(b"\n"):
                if not line:
                    continue
                db_key = fast_atoi(line.split(b"\t")[0])
                tid = treader.get_id(db_key)
                if tid < 0:
                    log.die(f"Invalid target key {db_key} in result entry "
                            f"{query_key}.")
                ts = tdb.seq_num(tid)
                tlen = len(ts)
                tbuf[:tlen] = ts
                tseq = tbuf
                is_identity = (qid == tid
                               and (par.include_identity or same_db))
                tkidx, tkpos, _ = extract_kmers(ts, offsets, span,
                                                alpha, -1)
                kmer_pos = []
                for x, j in zip(tkidx.tolist(), tkpos.tolist()):
                    i = qpos_lookup.get(x & 0xFFFF)
                    if i is not None:
                        kmer_pos.append(((i - j) & 0xFFFF, i, j))
                kmer_pos.sort()
                # diagonal stretch detection (alignbykmer.cpp:256-307)
                n_str = 0

                def put_stretch(vals):
                    nonlocal n_str
                    if n_str < len(stretche_vec):
                        stretche_vec[n_str] = vals
                    else:
                        stretche_vec.append(vals)
                    n_str += 1

                if len(kmer_pos) > 1:
                    rmin_i, rmax_i = 0xFFFF, 0
                    rmin_j, rmax_j = 0xFFFF, 0
                    rcnt = 0
                    # UINT_MAX doubles as the no-prev/no-next sentinel AND
                    # the real wrapped diagonal i-j == -1 (alignbykmer.cpp:
                    # 257,265) — a quirk kept for byte parity
                    prev_diag = 0xFFFFFFFF
                    prev_i = prev_j = 0
                    for ki in range(len(kmer_pos)):
                        _, ci, cj = kmer_pos[ki]
                        cur_diag = (ci - cj) & 0xFFFFFFFF
                        next_diag = 0xFFFFFFFF
                        if ki < len(kmer_pos) - 1:
                            next_diag = ((kmer_pos[ki + 1][1]
                                          - kmer_pos[ki + 1][2])
                                         & 0xFFFFFFFF)
                        if cur_diag != next_diag and cur_diag != prev_diag:
                            continue
                        if ((next_diag == cur_diag
                             or prev_diag == cur_diag)
                                and prev_i <= ci and prev_j <= cj):
                            rmin_i = min(rmin_i, ci)
                            rmax_i = max(rmax_i, ci)
                            rmin_j = min(rmin_j, cj)
                            rmax_j = max(rmax_j, cj)
                            rcnt += 1
                        prev_diag = cur_diag
                        prev_i, prev_j = ci, cj
                        if (next_diag != cur_diag
                                or ki == len(kmer_pos) - 1):
                            put_stretch([rmin_i, rmax_i, rmin_j, rmax_j,
                                         rcnt])
                            rmin_i, rmax_i = 0xFFFF, 0
                            rmin_j, rmax_j = 0xFFFF, 0
                            rcnt = 0
                            prev_i = prev_j = 0
                # chain DP over stretches (alignbykmer.cpp:309-340)
                live = sorted(stretche_vec[:n_str],
                              key=lambda s: (s[0], -s[1]))
                stretche_vec[:n_str] = live
                dp_prev = list(range(max(n_str, 1)))
                dp_score = [s[4] for s in live] or [0]
                best_path_score = 0
                last_in_best = 0
                for cur in range(n_str):
                    for prev in range(cur):
                        # NOTE reference compares j_start > prev i_end
                        # (alignbykmer.cpp:319-320), kept verbatim
                        if (live[cur][0] > live[prev][1]
                                and live[cur][2] > live[prev][1]):
                            dist = go + (live[prev][1]
                                         - live[cur][0]) * ge
                            cur_score = live[cur][4] * k * 2
                            with_prev = dp_score[prev] + dist + cur_score
                            if with_prev > dp_score[cur]:
                                dp_prev[cur] = prev
                                dp_score[cur] = with_prev
                    if dp_score[cur] > best_path_score:
                        last_in_best = cur
                        best_path_score = dp_score[cur]
                cur_id = last_in_best
                path = []
                if n_str == 0:
                    path.append(list(stale_stretch))
                else:
                    while dp_prev[cur_id] != cur_id:
                        path.append(list(live[cur_id]))
                        cur_id = dp_prev[cur_id]
                    path.append(list(live[cur_id]))
                if n_str > 0:
                    stale_stretch = list(live[0])
                # refine transition points (alignbykmer.cpp:350-399)
                for st in range(len(path) - 1, 0, -1):
                    scores = []
                    i, j = path[st][1], path[st][3]
                    score = 0
                    while i < path[st - 1][0] and j < path[st - 1][2]:
                        score += int(sub[qseq[i]][tseq[j]])
                        scores.append(score)
                        i += 1
                        j += 1
                    pos = len(scores)
                    scores.append(0)
                    max_score = max_pos = max_rev_pos = 0
                    rev_pos = 0
                    score = 0
                    i, j = path[st - 1][0], path[st - 1][2]
                    while i > path[st][1] and j > path[st][3]:
                        score += int(sub[qseq[i]][tseq[j]])
                        if scores[pos] + score > max_score:
                            max_score = scores[pos] + score
                            max_pos = pos
                            max_rev_pos = rev_pos
                        rev_pos += 1
                        pos -= 1
                        i -= 1
                        j -= 1
                    # Stretche fields are unsigned short — wrap
                    path[st - 1][0] = (path[st - 1][0] - max_rev_pos) & 0xFFFF
                    path[st - 1][2] = (path[st - 1][2] - max_rev_pos) & 0xFFFF
                    path[st][1] = (path[st][1] + max_pos) & 0xFFFF
                    path[st][3] = (path[st][3] + max_pos) & 0xFFFF
                # extend ends (alignbykmer.cpp:401-425)
                max_score = 0
                score = 0
                i, j = path[-1][0], path[-1][2]
                while i > -1 and j > -1:
                    score += int(sub[qseq[i]][tseq[j]])
                    if score > max_score:
                        path[-1][0] = i
                        path[-1][2] = j
                    i -= 1
                    j -= 1
                score = 0
                i, j = path[0][1], path[0][3]
                while i < qlen and j < tlen:
                    score += int(sub[qseq[i]][tseq[j]])
                    if score > max_score:
                        path[0][1] = i
                        path[0][3] = j
                    i += 1
                    j += 1
                # emit backtrace + chain score (alignbykmer.cpp:433-463)
                ids = 0
                score = 0
                bt = []
                for st in range(len(path) - 1, -1, -1):
                    i, j = path[st][0], path[st][2]
                    while i < path[st][1]:
                        bt.append("M")
                        ids += int(qseq[i] == tseq[j])
                        score += int(sub[qseq[i]][tseq[j]])
                        i += 1
                        j += 1
                    if st > 0:
                        score -= go
                        if path[st - 1][0] == path[st][1]:
                            for _ in range(path[st][3], path[st - 1][2]):
                                bt.append("I")
                                score -= ge
                        else:
                            for _ in range(path[st][1], path[st - 1][0]):
                                bt.append("D")
                                score -= ge
                # SmithWaterman::computeCov (StripedSmithWaterman.cpp:
                # 1762-1764) is symmetric in start/end and clamps to len
                def _sw_cov(start, end, ln):
                    return np.float32(min(ln, max(start, end))
                                      - min(start, end) + 1) / np.float32(ln)
                qcov = _sw_cov(path[-1][0], path[0][1], qlen)
                tcov = _sw_cov(path[-1][2], path[0][3], tlen)
                aln_len = len(bt)
                seq_id = (float(ids) / float(aln_len)) if aln_len else 0.0
                bit_score = int(evaluer.compute_bit_score(score) + 0.5)
                evalue = evaluer.compute_evalue(score, qlen)
                has_cov = autil.has_coverage(par.cov_thr, par.cov_mode,
                                             qcov, tcov)
                has_seq_id = seq_id >= (par.min_seq_id
                                        - np.finfo(np.float32).eps)
                has_evalue = evalue <= par.evalue
                if is_identity or (has_cov and has_seq_id and has_evalue):
                    r = Rec()
                    r.db_key = db_key
                    r.score = bit_score
                    r.seq_id = seq_id
                    r.eval = evalue
                    r.q_start, r.q_end, r.q_len = (path[-1][0], path[0][1],
                                                   qlen)
                    r.db_start, r.db_end, r.db_len = (path[-1][2],
                                                      path[0][3], tlen)
                    r.backtrace = "".join(bt)
                    out.append(r.to_line(True))
            w.write(query_key, "".join(out).encode())
    res.close()
    treader.close()
    if not same_db:
        qreader.close()
    return 0
