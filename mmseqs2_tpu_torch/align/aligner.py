"""Batched gapped aligner: SW score/endpoint scans on the device + host
backtrace.

Port of mmseqs2_tpu/align/aligner.py, keeping its device path only
(reference Matcher/SmithWaterman stack, src/alignment/Matcher.cpp:62-160,
src/alignment/StripedSmithWaterman.cpp):

  1. forward pass: every (query, target) pair of a batch of queries goes
     through the multi-query SW scan (ops/sw.py: the CUDA kernel on the card,
     its plain version on the CPU) for (score, qEnd, tEnd);
  2. gates (E-value, optimistic coverage from end positions) mirror
     ssw_align_private's early returns;
  3. reverse pass: each pair's reversed query prefix q[:qEnd+1] is a suffix
     of the query's reversed profile, so the same scan with a per-lane query
     offset and the reversed target prefix gives the start positions;
  4. the backtrace for accepted pairs runs host-side via the banded DP
     (ops/banded.py), exactly like the reference's banded_sw stage.

Modes mirror Matcher: SCORE_ONLY(0) stops after 1, SCORE_COV(1) after 3,
SCORE_COV_SEQID(2) runs all stages. Identity hits take the scoreIdentical
shortcut (including its int16 score accumulator).
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import get_device
from ..ops.banded import banded_align_scores
from ..ops.encode import (bucket_length, calc_local_aa_bias, round_bias_i8,
                          make_query_profile)
from ..ops.sw import pick_form, rows_computed, sw_multi
from ..profile.io import alignment_profile
from . import util

SCORE_ONLY = 0
SCORE_COV = 1
SCORE_COV_SEQID = 2

ALPHA_PAD = 32
PAD_LETTER = ALPHA_PAD - 1
BUCKET_MIN = 32        # smallest query/target length bucket

# Counters of the align stage, summed over every Aligner until reset_stats():
# pairs through the forward and reverse scans, DP cells of both (real = each
# lane's window rows times its target length, padded = the launches' buckets,
# computed = what the kernel's strips cover, ops/sw.py:rows_computed), host
# seconds spent in the scans (packing, launches, read-back) and in the
# backtrace, the kernels' device milliseconds (CUDA events; 0 on the CPU),
# the read-backs of the scans' results (one a launch), and for each launch
# in the int32 form the bound that ruled out int16.
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(pairs=0, rev_pairs=0, cells_real=0, cells_padded=0,
                 cells_computed=0, scan_s=0.0, kernel_ms=0.0,
                 backtrace_s=0.0, readbacks=0, int32_launches=[])


reset_stats()


@dataclass
class AlnResult:
    db_key: int
    score: int          # bit score (rounded int)
    raw_score: int
    seq_id: float
    eval: float
    q_start: int
    q_end: int
    q_len: int
    db_start: int
    db_end: int
    db_len: int
    qcov: float = 0.0
    dbcov: float = 0.0
    aln_length: int = 0
    backtrace: str = ""

    def to_line(self, add_backtrace: bool) -> str:
        return util.result_to_line(self, add_backtrace)


@dataclass
class QueryContext:
    q_num: np.ndarray           # numeric residues (int)
    comp_bias_i8: np.ndarray    # int8 per position
    profile: np.ndarray         # (ALPHA_PAD, Lq_bucket) int32, bias included
    bias: int                   # |min(mat)| + |min(comp bias)|  (gapless cap)


def sort_results(results):
    """Matcher::compareHits: eval asc, bit score desc, dbLen asc, key asc."""
    results.sort(key=lambda r: (r.eval, -r.score, r.db_len, r.db_key))
    return results


class Aligner:
    MULTI_NQ = 16          # query profiles per launch (8 above Lq 1024,
                           # 1 above 2048)
    MULTI_LANES = 16384    # (query, target) lanes per launch

    def __init__(self, submat, gap_open: int, gap_extend: int, evaluer,
                 comp_bias_corr: bool = True, comp_bias_scale: float = 1.0,
                 corr_score_weight: float = 0.0, device=None):
        self.submat = submat
        self.mat = submat.sub_matrix.astype(np.int32)
        self.go = int(gap_open)
        self.ge = int(gap_extend)
        if self.go < self.ge:
            raise ValueError("gap_open < gap_extend unsupported by the "
                             "prefix-cummax lazy-F closure")
        self.evaluer = evaluer
        self.comp_bias_corr = comp_bias_corr
        self.comp_bias_scale = comp_bias_scale
        self.corr_score_weight = float(corr_score_weight)
        self.mat_min = int(self.mat[: submat.alphabet_size,
                                    : submat.alphabet_size].min())
        self.device = get_device() if device is None else torch.device(device)

    # -- query setup ---------------------------------------------------------

    def init_query(self, q_num: np.ndarray) -> QueryContext:
        if self.comp_bias_corr:
            cb = calc_local_aa_bias(q_num, self.mat, self.submat.pback,
                                    self.comp_bias_scale)
            cb_i8 = round_bias_i8(cb)
            comp_bias_min = min(0, int(cb_i8.min()) if len(cb_i8) else 0)
        else:
            cb_i8 = np.zeros(len(q_num), dtype=np.int8)
            comp_bias_min = 0
        bias = abs(self.mat_min) + abs(comp_bias_min)
        profile = make_query_profile(
            q_num, self.mat, cb_i8, alpha_pad=ALPHA_PAD,
            pad_len=bucket_length(len(q_num), BUCKET_MIN))
        return QueryContext(q_num, cb_i8, profile, bias)

    def init_profile_query(self, prof_entry) -> QueryContext:
        """Query context for a DBTYPE_HMM_PROFILE entry.

        ssw_init profile branch (StripedSmithWaterman.cpp:1388-1407): the
        column scores are the profile's alignment scores (pssm/4, X row 0,
        pad rows -2^20), no composition bias, and the byte-kernel bias is
        |min| over the 20 amino-acid rows only. score_identical and the
        host backtrace read these columns as they read a sequence query's.
        """
        L = prof_entry.length
        prof = alignment_profile(prof_entry, alpha_pad=ALPHA_PAD,
                                 alphabet_size=self.submat.alphabet_size)
        bias = abs(min(0, int(prof[:20, :L].min()))) if L else 0
        pad = bucket_length(L, BUCKET_MIN) - L
        if pad:
            prof = np.pad(prof, ((0, 0), (0, pad)),
                          constant_values=-(1 << 20))
        q_num = prof_entry.query_num.astype(np.int64)
        cb_i8 = np.zeros(L, dtype=np.int8)
        return QueryContext(q_num, cb_i8, prof.astype(np.int32), bias)

    # -- identity shortcut ---------------------------------------------------

    def score_identical(self, ctx: QueryContext, t_num, mode):
        """SmithWaterman::scoreIdentical including the int16 accumulator."""
        L = len(ctx.q_num)
        per_pos = ctx.profile[np.asarray(t_num), np.arange(L)]
        raw = int(np.cumsum(per_pos.astype(np.int16), dtype=np.int16)[-1]) \
            if L else 0
        ev = self.evaluer.compute_evalue(raw, L)
        return AlnResult(
            db_key=-1, score=int(self.evaluer.compute_bit_score(raw) + 0.5),
            raw_score=raw, seq_id=1.0, eval=ev,
            q_start=0 if mode != SCORE_ONLY else -1, q_end=L - 1, q_len=L,
            db_start=0 if mode != SCORE_ONLY else -1, db_end=L - 1, db_len=L,
            qcov=1.0, dbcov=1.0, aln_length=L, backtrace="M" * L)

    # -- multi-query scan ------------------------------------------------------

    def _multi_scan(self, entries, reverse=False):
        """Scan (query, target) pairs through sw_multi.

        entries: list of (ref, qkey, profile (A, lqb) int32, target_seq,
        qoff, qend): the lane's profile rows [qoff, qend), its window. The
        forward pass's windows are [0, query length), the reverse pass's
        [qoff, lqb) of the reversed profile. Pairs are grouped by (query-
        length bucket, window bucket, target-length bucket), so that a
        launch's strips fit its longest window, and chunked to <= MULTI_NQ
        distinct profiles and MULTI_LANES lanes per launch. Each launch gets
        the real lengths (the forward pass's q_lens per profile, the target
        lengths per lane), the profiles' largest entry and the longest
        window from the host, so nothing is read back before it. Every chunk
        is launched before the first read-back, so host packing overlaps the
        device.

        Returns {ref: (score, qend, tend)} (qend in full-profile
        coordinates; callers subtract qoff for the reverse pass)."""
        t0 = time.perf_counter()
        dev = self.device
        timed = dev.type == "cuda"
        groups = {}
        for e in entries:
            key = (e[2].shape[1], bucket_length(max(e[5] - e[4], 1),
                                                BUCKET_MIN),
                   bucket_length(max(len(e[3]), 1), BUCKET_MIN))
            groups.setdefault(key, []).append(e)
        pending = []
        for (lqb, _, ltb), items in groups.items():
            NQ = (self.MULTI_NQ if lqb <= 1024
                  else 8 if lqb <= 2048 else 1)
            i = 0
            while i < len(items):
                profs, ends, slot, refs = [], [], {}, []
                n = min(self.MULTI_LANES, len(items) - i)
                tb = np.full((ltb, n), PAD_LETTER, np.int8)
                qsel, qoffs, qends, tlens = (np.zeros(n, np.int32)
                                             for _ in range(4))
                lane = 0
                while i < len(items) and lane < n:
                    ref, qkey, prof, seq, qo, qe = items[i]
                    if qkey not in slot:
                        if len(profs) == NQ:
                            break
                        slot[qkey] = len(profs)
                        profs.append(prof)
                        ends.append(qe)
                    tb[: len(seq), lane] = seq
                    qsel[lane] = slot[qkey]
                    qoffs[lane] = qo
                    qends[lane] = qe
                    tlens[lane] = len(seq)
                    refs.append(ref)
                    lane += 1
                    i += 1
                pf = np.concatenate(profs, axis=0)
                window = int((qends[:lane] - qoffs[:lane]).max())
                prof_max = int(pf.max())
                form = pick_form(window, prof_max, self.go, self.ge)
                if form == "int32":
                    STATS["int32_launches"].append(dict(
                        window=window, prof_max=prof_max,
                        score_bound=window * max(prof_max, 0), go=self.go,
                        ge=self.ge))
                # the reverse pass's windows end at lqb (q_lens None), the
                # forward pass's start at 0 (qoff None)
                win = (qoffs[:lane], None) if reverse else (
                    None, np.array(ends, np.int32))
                args = [None if a is None else
                        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (pf, tb[:, :lane], qsel[:lane], *win,
                                  tlens[:lane])]
                ev = None
                if timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = sw_multi(*args[:4], go=self.go, ge=self.ge,
                               q_lens=args[4], t_lens=args[5],
                               prof_max=prof_max, max_window=window)
                if timed:
                    ev[1].record()
                STATS["cells_padded"] += lane * lqb * ltb
                STATS["cells_computed"] += int((rows_computed(
                    form, window, qends[:lane], qoffs[:lane])
                    * tlens[:lane]).sum())
                pending.append((refs, torch.stack(out), ev))
        result = {}
        for refs, out, ev in pending:
            s, qe, te = out.cpu().numpy()
            STATS["readbacks"] += 1
            if ev is not None:
                STATS["kernel_ms"] += ev[0].elapsed_time(ev[1])
            for lane, ref in enumerate(refs):
                result[ref] = (int(s[lane]), int(qe[lane]), int(te[lane]))
        STATS["scan_s"] += time.perf_counter() - t0
        return result

    # -- main entry -----------------------------------------------------------

    def align_query(self, ctx: QueryContext, target_keys, target_seqs,
                    target_lens, identity_flags, mode=SCORE_COV_SEQID,
                    cov_mode=0, cov_thr=0.0, eval_thr=1e-3,
                    seq_id_mode=util.SEQ_ID_ALN_LEN):
        """Align one query against candidate targets; returns AlnResult list
        in input order. Acceptance/early-exit is the caller's job (it depends
        on result order and maxAccept/maxReject)."""
        return self.align_batch(
            [(ctx, target_keys, target_seqs, target_lens, identity_flags)],
            mode=mode, cov_mode=cov_mode, cov_thr=cov_thr,
            eval_thr=eval_thr, seq_id_mode=seq_id_mode)[0]

    def align_batch(self, jobs, mode=SCORE_COV_SEQID, cov_mode=0,
                    cov_thr=0.0, eval_thr=1e-3,
                    seq_id_mode=util.SEQ_ID_ALN_LEN):
        """Align MANY queries in few device calls.

        jobs: list of (ctx, target_keys, target_seqs, target_lens,
        identity_flags). All (query, target) pairs across jobs share the
        forward and reverse scans. `eval_thr` is one threshold for every
        job or a list of one per job. Returns per-job AlnResult lists in
        input order; semantics identical to align_query."""
        eval_thrs = (list(eval_thr) if isinstance(eval_thr, (list, tuple))
                     else [eval_thr] * len(jobs))
        per_results = []
        per_sw = []
        fwd_entries = []
        for j, (ctx, keys, seqs, lens, ident) in enumerate(jobs):
            results = [None] * len(keys)
            sw_idx = []
            for i, isid in enumerate(ident):
                if isid:
                    res = self.score_identical(ctx, seqs[i], mode)
                    res.db_key = keys[i]
                    res.db_len = int(lens[i])
                    results[i] = res
                else:
                    sw_idx.append(i)
            per_results.append(results)
            per_sw.append(sw_idx)
            qL = len(ctx.q_num)
            for i in sw_idx:
                fwd_entries.append(((j, i), j, ctx.profile, seqs[i], 0, qL))
                STATS["cells_real"] += qL * len(seqs[i])
            STATS["pairs"] += len(sw_idx)

        # 1. forward: score + end positions
        fwd = self._multi_scan(fwd_entries)

        # 2. gates; collect reverse-pass work across all jobs
        rev_targets, rev_ref, rev_qe = [], [], []
        for j, (ctx, keys, seqs, lens, ident) in enumerate(jobs):
            qL = len(ctx.q_num)
            for i in per_sw[j]:
                raw, qe, te = fwd[(j, i)]
                tL = int(lens[i])
                ev = self.evaluer.compute_evalue(raw, qL)
                res = AlnResult(
                    db_key=keys[i],
                    score=int(self.evaluer.compute_bit_score(raw) + 0.5),
                    raw_score=raw, seq_id=0.0, eval=ev,
                    q_start=-1, q_end=qe, q_len=qL,
                    db_start=-1, db_end=te, db_len=tL,
                    aln_length=max(abs(qe + 1), abs(te + 1)))
                per_results[j][i] = res
                if te == -1 or mode == SCORE_ONLY:
                    if te != -1:
                        res.seq_id = util.estimate_seq_id_by_score_per_col(
                            raw, max(qe, 1), max(te, 1))
                    continue
                res.qcov = float(util.compute_cov(0, qe, qL))
                res.dbcov = float(util.compute_cov(0, te, tL))
                low_cov = not util.has_coverage(cov_thr, cov_mode,
                                                res.qcov, res.dbcov)
                if ev > eval_thrs[j] or low_cov:
                    continue  # ssw_align_private early return (mode 1, 2)
                rev_targets.append(seqs[i][: te + 1][::-1].copy())
                rev_qe.append(qe)
                rev_ref.append((j, i))

        # 3. reverse pass -> start positions: each pair's reversed query
        # prefix is a SUFFIX of the query's reversed profile, so one shared
        # profile per query + a per-lane qoff covers every pair
        rev_entries = []
        rev_prof = {}
        rev_qoff = {}
        for k, (j, i) in enumerate(rev_ref):
            ctx = jobs[j][0]
            if j not in rev_prof:
                rev_prof[j] = np.ascontiguousarray(ctx.profile[:, ::-1])
            qoff = ctx.profile.shape[1] - 1 - rev_qe[k]
            rev_qoff[k] = qoff
            rev_entries.append((k, j, rev_prof[j], rev_targets[k], qoff,
                                ctx.profile.shape[1]))
            STATS["cells_real"] += (rev_qe[k] + 1) * len(rev_targets[k])
        STATS["rev_pairs"] += len(rev_entries)
        rev_out = {}
        for k, (rs, rqe2, rte2) in self._multi_scan(
                rev_entries, reverse=True).items():
            rev_out[k] = (rs, rqe2 - rev_qoff[k], rte2)

        t_bt = time.perf_counter()
        for k, (j, i) in enumerate(rev_ref):
            ctx, keys, seqs, lens, ident = jobs[j]
            qL = len(ctx.q_num)
            res = per_results[j][i]
            rs, rqe, rte = rev_out[k]
            if rs != res.raw_score:
                raise RuntimeError(
                    f"forward/reverse SW score mismatch {rs} != "
                    f"{res.raw_score} (target {res.db_key})")
            res.q_start = res.q_end - rqe
            res.db_start = res.db_end - rte
            res.qcov = float(util.compute_cov(res.q_start, res.q_end, qL))
            res.dbcov = float(util.compute_cov(res.db_start, res.db_end,
                                               res.db_len))
            res.aln_length = max(abs(res.q_end - res.q_start),
                                 abs(res.db_end - res.db_start)) + 1
            low_cov = not util.has_coverage(cov_thr, cov_mode,
                                            res.qcov, res.dbcov)
            if mode == SCORE_COV:
                res.seq_id = util.estimate_seq_id_by_score_per_col(
                    res.raw_score, max(res.q_end - res.q_start, 1),
                    max(res.db_end - res.db_start, 1))
                continue
            if low_cov:
                continue   # alignStartPosBacktrace returns pre-banded

            # 4. backtrace (host banded DP) + real sequence identity
            t_num = seqs[i]
            t_win = t_num[res.db_start: res.db_end + 1]
            q_idx = np.arange(res.q_start, res.q_end + 1)
            s_win = ctx.profile[np.asarray(t_win)[None, :],
                                q_idx[:, None]]
            bt = banded_align_scores(t_win, s_win, res.raw_score,
                                     self.go, self.ge)
            res.backtrace = bt
            res.aln_length = len(bt)
            q_win = ctx.q_num[res.q_start:]
            t_win = t_num[res.db_start:]
            qi = ti = 0
            aa_ids = 0
            m_scores = []
            for op in bt:
                if op == 'M':
                    aa_ids += int(t_win[ti] == q_win[qi])
                    if self.corr_score_weight > 0.0:
                        # int8 per-column match score incl. bias
                        # (StripedSmithWaterman.cpp:1289-1292)
                        m_scores.append(np.int8(
                            ctx.profile[int(t_win[ti]),
                                        res.q_start + qi]))
                    qi += 1
                    ti += 1
                elif op == 'I':
                    qi += 1
                else:
                    ti += 1
            if self.corr_score_weight > 0.0:
                # neighbour-column score correlation bonus
                # (StripedSmithWaterman.cpp:1249-1253,1338-1362)
                sc = np.asarray(m_scores, dtype=np.int64)
                corr = sum(int((sc[lag:] * sc[:-lag]).sum())
                           for lag in (1, 2, 3, 4) if len(sc) > lag)
                new_raw = int(np.float32(res.raw_score)
                              + np.float32(corr)
                              * np.float32(self.corr_score_weight))
                res.raw_score = new_raw
                res.eval = self.evaluer.compute_evalue(new_raw, qL)
                res.score = int(
                    self.evaluer.compute_bit_score(new_raw) + 0.5)
            res.seq_id = float(util.compute_seq_id(
                seq_id_mode, aa_ids, qL, res.db_len, res.aln_length))
        STATS["backtrace_s"] += time.perf_counter() - t_bt
        return per_results
