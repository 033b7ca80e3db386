"""Stage functions of the device k-mer prefilter pipeline, in PyTorch.

Port of mmseqs2_tpu/prefilter/device_stages.py: the same stages with the
same names, as plain functions on tensors; every tensor a stage makes lies
on the device of its inputs. Semantics per stage are documented in
prefilter/device.py; the host oracle is prefilter/query_matcher.py
(reference: src/prefiltering/QueryMatcher.cpp). The ungapped diagonal
rescore between the candidate stage and keep-max is the kernel of
ops/rescore.py.

No stage reads a value back to the host: each works on fixed-size buffers
(the sizes of its inputs, or the capacities it is given) with a validity
mask, so a flush is enqueued without a synchronisation. Invalid slots hold
I32_MAX in their qid and id and are replaced by 0 before every gather;
compactions scatter into a buffer with one spare slot that takes every
dropped element.
"""

import torch

from .query_matcher import UCHAR_MAX

I32_MAX = 2147483647
BIG = 0x40000000
i32 = torch.int32


def _shift1(x, fill):
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _arange(n, like):
    return torch.arange(n, dtype=i32, device=like.device)


def _compact(keep, pos, cap, fill, values):
    """values[keep] in order at the front of a (cap,) buffer of `fill`;
    elements not kept, or at a position past cap, go to the spare slot."""
    wpos = torch.where(keep & (pos < cap), pos, cap)
    out = values.new_full((cap + 1,), fill)
    out[wpos] = values
    return out[:cap]


def sort_dup_packed(qtid, diag, tb):
    """Packed-key sort + double-diagonal detection.

    qtid: (H,) i32 keys `qid << tb | id` in expansion order, I32_MAX for
    invalid; diag: (H,) i32 whose low 16 bits are the diagonal. The sort is
    stable: the double-diagonal rule depends on the order of one id's
    entries. An id's first entry counts when its u8 diagonal is 0 (the
    reference's byte-array quirk), a later one when it repeats its
    predecessor's u8 diagonal; a "last duplicate wins" scan then drops the
    repeats of one run. Returns (qtid, diag, valid, hqid, ids, cand) in
    sorted order."""
    qtid, order = torch.sort(qtid, stable=True)
    diag = diag[order]
    valid = qtid != I32_MAX
    hqid = torch.where(valid, qtid >> tb, I32_MAX)
    ids = torch.where(valid, qtid & ((1 << tb) - 1), I32_MAX)
    d8 = diag & 0xFF
    first_of_id = qtid != _shift1(qtid, -1)
    dup = torch.where(first_of_id, d8 == 0, d8 == _shift1(d8, 0)) & valid
    # the last duplicate strictly before each entry, if any
    gidx = _arange(qtid.shape[0], qtid)
    last = torch.cummax(torch.where(dup, gidx, -1), 0).values
    prev = _shift1(last, -1)
    p = prev.clamp(min=0).long()
    run_dup = (prev >= 0) & (d8[p] == d8) & (qtid[p] == qtid)
    cand = dup & ~run_dup
    return qtid, diag, valid, hqid, ids, cand


def compact_candidates(cand, hqid, ids, diag, *, c_cap):
    """Front-compact candidate triples into c_cap slots."""
    n_cand = cand.sum(dtype=i32)
    pos = torch.cumsum(cand, 0) - 1
    cqid = _compact(cand, pos, c_cap, I32_MAX, hqid)
    cid = _compact(cand, pos, c_cap, I32_MAX, ids)
    cdiag = _compact(cand, pos, c_cap, 0, diag)
    cvalid = _arange(c_cap, cand) < n_cand.clamp(max=c_cap)
    return cqid, cid, cdiag, cvalid, n_cand


def stage_candidates_pre(qtid, diag, *, c_cap, tb):
    """Candidate stage for flushes whose posting expansion was done on the
    host: the shift-packed `qid << tb | id` key (I32_MAX padding) and the
    16-bit diagonal per expansion come in; the device picks up at the sort.
    Returns (cqid, cid, cdiag, cvalid, n_cand, total)."""
    total = (qtid != I32_MAX).sum(dtype=i32)
    qtid, diag, valid, hqid, ids, cand = sort_dup_packed(
        qtid, diag.to(i32) & 0xFFFF, tb)
    cqid, cid, cdiag, cvalid, n_cand = compact_candidates(
        cand, hqid, ids, diag, c_cap=c_cap)
    return cqid, cid, cdiag, cvalid, n_cand, total


def stage_keepmax(cqid, cid, cscore, cvalid, *, c_cap):
    """keepMaxScoreElementOnly: per (qid, id) keep the max score, first on
    ties in scan order. Returns the is_best mask. (Integer scatter
    reductions are exact, so the result does not depend on their order.)"""
    first_c = ((cqid != _shift1(cqid, -1)) | (cid != _shift1(cid, -1))) \
        & cvalid
    seg = torch.cumsum(first_c, 0) - 1
    seg = torch.where(cvalid, seg, c_cap - 1)
    segmax = cscore.new_full((c_cap,), -1).scatter_reduce_(
        0, seg, torch.where(cvalid, cscore, -1), "amax")
    at_max = cvalid & (cscore == segmax[seg])
    gidx = _arange(c_cap, cqid)
    segfirst = gidx.new_full((c_cap,), I32_MAX).scatter_reduce_(
        0, seg, torch.where(at_max, gidx, I32_MAX), "amin")
    return at_max & (segfirst[seg] == gidx)


def stage_hist(cqid, cscore, is_best, *, n_q, c_cap):
    """Per-query 256-bin score histogram over the per-id best scores."""
    hseg = torch.where(is_best, cqid.long() * 256 + cscore, n_q * 256)
    hist = torch.zeros(n_q * 256 + 1, dtype=i32, device=cqid.device)
    hist.scatter_add_(0, hseg, torch.ones(c_cap, dtype=i32,
                                          device=cqid.device))
    return hist[:-1].reshape(n_q, 256)


def threshold_from_hist(hist, max_hits, min_diag_thr):
    """computeScoreThreshold (QueryMatcher.h:211-221): largest s in [1,255]
    whose descending-cumulative count reaches max_hits, else 0."""
    cum_desc = torch.cumsum(hist.flip(1), 1).flip(1)
    s_idx = _arange(256, hist)[None, :]
    ok = (cum_desc >= max_hits) & (s_idx >= 1)
    thr0 = torch.where(ok, s_idx, 0).max(1).values
    thr = thr0.clamp(min=min_diag_thr)
    truncated = thr >= UCHAR_MAX
    return thr, truncated


def stage_select(cqid, cid, cdiag, cscore, cexact, cvalid, is_best, thr,
                 identity, *, c_cap, max_hits, out_sz):
    """Filter (score >= thr, not the identity hit), rank per query in
    (capped score desc, id asc) order, keep rank < max_hits less one where
    an identity hit was injected, compact to out_sz slots. `cexact` is
    carried along with the diagonal. Returns (kqid, kid, kdiag, kscore,
    kexact, kvalid) in selection-sorted order."""
    q0 = torch.where(cvalid, cqid, 0).long()
    sel = is_best & (cscore >= thr[q0]) & ~(cid == identity[q0])
    # (qid << 8 | 255 - score, id) as one i64 key; the (qid, id) pair is
    # unique after keep-max, so the keys are. Padding sorts last.
    key = torch.where(sel, cqid * 256 + (255 - cscore), I32_MAX)
    sid = torch.where(sel, cid, I32_MAX)
    _, order = torch.sort((key.long() << 32) | sid.long(), stable=True)
    key, sid2, sdiag2, sexact2 = key[order], sid[order], cdiag[order], \
        cexact[order]
    ssel = key != I32_MAX
    sq = torch.where(ssel, key // 256, I32_MAX)
    ss = torch.where(ssel, key & 0xFF, 0)
    gidx = _arange(c_cap, cqid)
    qfirst = sq != _shift1(sq, -1)
    seg_start = torch.cummax(torch.where(qfirst, gidx, 0), 0).values
    rank = gidx - seg_start
    avail = max_hits - (identity[torch.where(ssel, sq, 0).long()] >= 0).to(
        i32)
    keep = ssel & (rank < avail)

    kpos = torch.cumsum(keep, 0) - 1
    kqid = _compact(keep, kpos, out_sz, I32_MAX, sq)
    kid = _compact(keep, kpos, out_sz, I32_MAX, sid2)
    kdiag = _compact(keep, kpos, out_sz, 0, sdiag2)
    kscore = _compact(keep, kpos, out_sz, 0, 255 - ss)
    kexact = _compact(keep, kpos, out_sz, 0, sexact2)
    kvalid = _arange(out_sz, cqid) < keep.sum(dtype=i32)
    return kqid, kid, kdiag, kscore, kexact, kvalid


def stage_finalize(kqid, kid, kdiag, final_score, kvalid):
    """Final per-query ordering: query, score desc, id asc (a stable sort
    on three keys, as two chained stable sorts). Returns (qid key, score
    key, kid, kdiag, final_score, kvalid as i32), sorted."""
    k1 = torch.where(kvalid, kqid, I32_MAX)
    k2 = torch.where(kvalid, BIG - final_score, I32_MAX)
    _, o1 = torch.sort((k2.long() << 32) | kid.long(), stable=True)
    _, o2 = torch.sort(k1[o1], stable=True)
    order = o1[o2]
    return (k1[order], k2[order], kid[order], kdiag[order],
            final_score[order], kvalid[order].to(i32))
