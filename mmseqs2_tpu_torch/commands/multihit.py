"""Multihit subsystem: set-vs-set search aggregation.

Reference: src/multihit/ — Aggregation base (Aggregation.cpp:24-97 groups a
query entry's hit lines by target set via `<target>_member_to_set`, emits
one aggregated line per set in ascending set-key order), `besthitperset`
(besthitperset.cpp:28-123: keep the lowest-p-value line per target set,
substitute column 1 with the log-corrected p-value), `combinepvalperset`
(combinepvalperset.cpp:11-223: truncated-Fisher / min-p / product /
truncated-product p-value aggregation per query set), plus the
`result2stats` statistics command (src/util/result2stats.cpp) and
`mergeresultsbyset` (src/util/mergeresultsbyset.cpp) they compose with.

Port of mmseqs2_tpu/commands/multihit.py, whole: host code.
"""

import math

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from .common import fast_atoi

AGGREGATION_MODE_MULTIHIT = 0
AGGREGATION_MODE_MIN_PVAL = 1
AGGREGATION_MODE_PRODUCT = 2
AGGREGATION_MODE_TRUNCATED_PRODUCT = 3

DBL_MIN = 2.2250738585072014e-308
DBL_MAX = 1.7976931348623157e+308


def _sstr_double(x: float) -> str:
    return f"{x:.3E}"


def _aggregate_run(result_path, out_path, member_to_set_path, fn):
    """Aggregation::run — group each entry's lines by target set, emit one
    line per set (ascending set key)."""
    m2s = DBReader(member_to_set_path)
    reader = DBReader(result_path)
    writer = DBWriter(out_path, dbt.DBTYPE_ALIGNMENT_RES)
    for i in range(reader.size):
        key = reader.get_db_key(i)
        groups = {}
        for line in reader.get_data(i).split(b"\n"):
            if not line:
                continue
            cols = line.decode().split("\t")
            tkey = fast_atoi(cols[0].encode())
            sid = m2s.get_id(tkey)
            if sid < 0:
                log.die(f"Invalid target database key {cols[0]}.")
            set_key = fast_atoi(m2s.get_data(sid).split()[0])
            groups.setdefault(set_key, []).append(cols)
        buf = []
        for set_key in sorted(groups):
            buf.append(fn(groups[set_key], key, set_key))
            buf.append("\n")
        writer.write(key, "".join(buf).encode())
    writer.close()
    m2s.close()
    reader.close()
    return 0


def besthitperset(par, command):
    """Best (lowest p-value) hit per target set; column 1 replaced by the
    log-corrected p-value (besthitperset.cpp:28-115)."""
    _q, target_path, result_path, out_path = par.filenames[:4]
    size_reader = DBReader(target_path + "_set_size")
    simple = par.simple_best_hit

    def agg(rows, _query_key, target_set_key):
        sid = size_reader.get_id(target_set_key)
        if sid < 0:
            log.die(f"Invalid target size database key {target_set_key}.")
        nbr_genes = fast_atoi(size_reader.get_data(sid).split()[0])
        best_score = -DBL_MAX
        second_best = -DBL_MAX
        best_eval = DBL_MAX
        best = None
        for row in rows:
            ev = float(row[3])
            pval = ev / nbr_genes
            if pval == 0:
                pval = DBL_MIN
            score = -math.log(pval)
            if simple or len(rows) < 2:
                if best_eval > ev:
                    best_eval = ev
                    best = row
            else:
                if score >= best_score:
                    second_best = best_score
                    best_score = score
                    best = row
                elif score > second_best:
                    second_best = score
        if simple or len(rows) < 2:
            if best_eval == 0:
                log_pval = math.log(DBL_MIN)
            elif 0 < best_eval < 10e-4:
                log_pval = math.log(best_eval)
            else:
                log_pval = math.log(1 - math.exp(-best_eval))
        else:
            log_pval = second_best - best_score
        if best is None:
            return ""
        out = list(best)
        out[1] = _sstr_double(log_pval)
        return "\t".join(out)

    rc = _aggregate_run(result_path, out_path,
                        target_path + "_member_to_set", agg)
    size_reader.close()
    return rc


def _lbin_coeff(lgamma, m, k):
    return lgamma[m + 1] - lgamma[m - k + 1] - lgamma[k + 1]


def _precompute_log_b(orf_count, pval_thr, lgamma):
    """combinepvalperset.cpp:17-26."""
    log_b = [0.0] * orf_count
    log_thr = math.log(pval_thr)
    log_one_minus = math.log(1 - pval_thr)
    log_b[orf_count - 1] = orf_count * log_thr
    for i in range(orf_count - 2, -1, -1):
        k = i + 1
        new_term = (_lbin_coeff(lgamma, orf_count, k) + k * log_thr
                    + (orf_count - k) * log_one_minus)
        log_b[i] = log_b[i + 1] + math.log(
            1 + math.exp(new_term - log_b[i + 1]))
    return log_b


def combinepvalperset(par, command):
    """P-value aggregation per query set (combinepvalperset.cpp:84-223)."""
    query_path, target_path, result_path, out_path = par.filenames[:4]
    qsize = DBReader(query_path + "_set_size")
    tsize = DBReader(target_path + "_set_size")
    num_target_sets = tsize.size
    alpha = par.alpha
    mode = par.aggregation_mode

    max_orf = max(fast_atoi(qsize.get_data(i).split()[0])
                  for i in range(qsize.size))
    # C lgamma(0) = +inf; Python's raises
    lgamma = [math.inf] + [math.lgamma(i) for i in range(1, max_orf + 2)]

    state = {}

    def prepare(query_set_key):
        orf_count = fast_atoi(
            qsize.get_data(qsize.get_id(query_set_key)).split()[0])
        state["orf_count"] = orf_count
        if mode == AGGREGATION_MODE_MULTIHIT and orf_count > 0:
            thr = alpha / (orf_count + 1)
            if 0.0 < thr < 1.0:
                state["log_b"] = _precompute_log_b(orf_count, thr, lgamma)

    def agg(rows, query_set_key, target_set_key):
        prepare(query_set_key)
        orf_count = state["orf_count"]
        out = f"{target_set_key}\t"
        if mode == AGGREGATION_MODE_MULTIHIT:
            thr = alpha / (orf_count + 1)
            if thr == 0.0:
                return out + str(num_target_sets)
            log_thr = math.log(thr)
            r = 0.0
            for row in rows:
                log_p = float(row[1])
                if log_p < log_thr:
                    r -= log_p - log_thr
            if r == 0.0:
                return out + str(num_target_sets)
            if math.isinf(r):
                return out + "0"
            exp_minus_r = math.exp(-r)
            if thr == 1.0:
                return out + _sstr_double(exp_minus_r * num_target_sets)
            log_r = math.log(r)
            log_b = state["log_b"]
            fisher = sum(math.exp(i * log_r - lgamma[i + 1] + log_b[i])
                         for i in range(orf_count))
            pval = exp_minus_r * fisher
        elif mode == AGGREGATION_MODE_MIN_PVAL:
            min_log = min([0.0] + [float(r[1]) for r in rows])
            pval = 1 - math.exp(-math.exp(min_log) * orf_count)
        elif mode == AGGREGATION_MODE_PRODUCT:
            pval = math.exp(sum(float(r[1]) for r in rows))
        elif mode == AGGREGATION_MODE_TRUNCATED_PRODUCT:
            log_thr = math.log(alpha / (orf_count + 1))
            min_log = 0.0
            sum_log = 0.0
            k = 0
            for row in rows:
                log_p = float(row[1])
                if log_p < min_log:
                    min_log = log_p if log_p == 0 else -log_p
                if log_p < log_thr:
                    sum_log -= log_p - log_thr
                    k += 1
            if k == 0:
                return out + _sstr_double(min_log)
            return out + _sstr_double(sum_log - log_thr)
        else:
            log.die("Invalid aggregation function!")
        return out + _sstr_double(pval * num_target_sets)

    rc = _aggregate_run(result_path, out_path,
                        target_path + "_member_to_set", agg)
    qsize.close()
    tsize.close()
    return rc


# ---------------------------------------------------------------- utilities

def mergeresultsbyset(par, command):
    """Concatenate per-member result entries into per-set entries
    (src/util/mergeresultsbyset.cpp)."""
    set_path, result_path, out_path = par.filenames[:3]
    sets = DBReader(set_path)
    res = DBReader(result_path)
    writer = DBWriter(out_path, res.base_type, res.extended_type)
    for i in range(sets.size):
        buf = []
        for line in sets.get_data(i).split(b"\n"):
            if not line:
                continue
            key = fast_atoi(line.split()[0])
            rid = res.get_id(key)
            if rid < 0:
                log.die(f"Missing result entry {key}")
            buf.append(res.get_data(rid))
        writer.write(sets.get_db_key(i), b"".join(buf))
    writer.close()
    return 0


def tsv2db(par, command):
    """TSV (key \\t value) -> DB; consecutive identical first columns merge
    into one entry (src/util/tsv2db.cpp)."""
    tsv_path, out_path = par.filenames[:2]
    writer = DBWriter(out_path, par.output_dbtype)
    cur_key = None
    buf = []
    with open(tsv_path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if not line:
                continue
            key_s, _, rest = line.partition(b"\t")
            key = fast_atoi(key_s)
            if cur_key is not None and key != cur_key:
                writer.write(cur_key, b"".join(buf))
                buf = []
            cur_key = key
            buf.append(rest + b"\n")
    if cur_key is not None:
        writer.write(cur_key, b"".join(buf))
    writer.close()
    return 0


# lookup tables: reference src/commons/AminoAcidLookupTables.h
_DOOLITTLE = {
    "a": 6.3, "r": 0.0, "n": 1.0, "d": 1.0, "c": 7.0, "q": 1.0, "e": 1.0,
    "g": 4.1, "h": 1.3, "i": 9.0, "l": 5.2, "k": 0.6, "m": 6.4, "f": 7.2,
    "p": 2.9, "s": 3.6, "t": 3.8, "w": 3.6, "y": 3.2, "v": 8.7, "x": 0.0,
    "0": 0.0, "1": 0.0,
}

_PKS = {"c": 9.00, "d": 4.05, "e": 4.45, "h": 5.98, "k": 10.00, "r": 12.00,
        "y": 10.00, "1": 3.55, "0": 7.50}
_CHARGE_SIGN = {"c": -1.0, "d": -1.0, "e": -1.0, "y": -1.0, "h": 1.0,
                "k": 1.0, "r": 1.0, "1": -1.0, "0": 1.0}
_CHARGES = {k: np.float32(_CHARGE_SIGN[k]) / np.float32(
    1 + 10 ** (_CHARGE_SIGN[k] * (7.0 - _PKS[k]))) for k in _PKS}


def _avg_on_aa(values, seq: bytes) -> float:
    ret = np.float32(values.get("0", 0.0)) + np.float32(values.get("1", 0.0))
    n = 0
    for ch in seq:
        if ch in (0, 10):
            break
        v = values.get(chr(ch).lower())
        if v is not None:
            ret = np.float32(ret + np.float32(v))
        n += 1
    return float(ret / np.float32(max(1, n)))


def _seqlen_stat(seq: bytes) -> int:
    n = 0
    for ch in seq:
        c = chr(ch)
        if ("A" <= c < "Z") or ("a" <= c < "z") or c == "*":
            n += 1
        else:
            break
    return n


def result2stats(par, command):
    """Per-entry statistics (src/util/result2stats.cpp)."""
    _q, target_path, result_path, out_path = par.filenames[:4]
    stat = par.stat
    res = DBReader(result_path)
    writer = DBWriter(out_path, dbt.DBTYPE_GENERIC_DB)

    target = None
    if stat in ("doolittle", "charges", "seqlen", "strlen"):
        target = DBReader(target_path)

    for i in range(res.size):
        data = res.get_data(i)
        if stat == "linecount":
            out = str(data.count(b"\n")) + "\n"
        elif stat in ("mean", "min", "max", "sum"):
            vals = []
            for line in data.split(b"\n"):
                if not line:
                    continue
                try:
                    vals.append(float(line.split()[0]))
                except (ValueError, IndexError):
                    log.warning(f"Invalid value in entry {i}!")
            if stat == "mean":
                v = sum(vals) / max(1, len(vals))
            elif stat == "min":
                v = min(vals) if vals else DBL_MAX
            elif stat == "max":
                v = max(vals) if vals else 2.2250738585072014e-308
            else:
                v = sum(vals)
            out = _sstr_double(v) + "\n"
        elif stat == "firstline":
            out = data.split(b"\n")[0].decode() + "\n"
        elif stat in ("doolittle", "charges", "seqlen", "strlen"):
            parts = []
            for line in data.split(b"\n"):
                if not line:
                    continue
                key = fast_atoi(line.split()[0])
                tid = target.get_id(key)
                if tid < 0:
                    log.warning(f"Missing target key {key} in entry {i}!")
                    continue
                seq = target.get_data(tid)
                if stat == "doolittle":
                    parts.append(f"{_avg_on_aa(_DOOLITTLE, seq):.3f}")
                elif stat == "charges":
                    parts.append(f"{_avg_on_aa(_CHARGES, seq):.3f}")
                elif stat == "seqlen":
                    parts.append(str(_seqlen_stat(seq)))
                else:
                    parts.append(str(len(seq.rstrip(b"\x00"))))
            out = "".join(p + "\n" for p in parts)
        else:
            log.die(f"Unrecognized statistic: {stat}")
        writer.write(res.get_db_key(i), out.encode())
    writer.close()
    return 0
