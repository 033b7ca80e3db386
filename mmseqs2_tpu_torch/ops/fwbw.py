"""Forward-backward posterior alignment (B5): the partition function, the
posterior match probabilities P and the maximum-accuracy (MAC) DP of many
(query, target) pairs.

Port of mmseqs2_tpu/ops/fwbw.py (`_fwbw_logzm` :46, `_fwbw_p` :100, `_mac`
:116, batched by `_fwbw_batch` :241 and walked back by `fwbw_align_batch`),
reference src/alignment/Fwbw.cpp. Rows are target positions, columns query
positions; go and ge are NEGATIVE gap scores, T the temperature:

  zm(i,j) = (zm(i-1,j-1) + ze(i-1,j-1) + zf(i-1,j-1) + 1) e^{S(i,j)/T}
  ze(i,j) = ze(i,j-1) e^{ge/T} + zm(i,j-1) e^{go/T}
  zf(i,j) = zf(i-1,j) e^{ge/T} + zm(i-1,j) e^{go/T}

in f32, every row divided by its zm maximum and the log of the scale
carried (the JAX package's whole-row rescaling, not Fwbw.cpp's blocks of
16); the same on the reversed pair gives the backward pass, and

  P(i,j) = exp(log zm_f(i,j) + log zm_b(i,j) - S(i,j)/T - logsumexp(zm_f)).

The MAC DP over P with threshold mact (local mode) writes one uint8 state a
cell (STOP, M, I, D in calculate_max4's tie order) and returns the first
strictly largest cell.

  fwbw        the wrapper: CUDA tensors go to the hand-written kernels
              (csrc/fwbw.cu, built at first use), CPU tensors to the plain
              version; anything else raises. `fwbw.launches` counts calls
              that launched the kernels (the two launches of one call, the
              partition function's and P with the MAC's, are one B5
              launch).
  fwbw_plain  the same function in plain PyTorch, row by row as the JAX
              package computes it, on any device; the tests and the CPU
              route use it, the card's path does not.
  launch_plan the kernels' plan of a batch, on the host: a warp a pair for
              queries of at most WARP_COLS residues, a block a pair past
              it, each form's pairs by target length, longest first.

A batch of pairs (PairBatch) is ragged: the residues (uint8 codes below the
matrix's size) of every query and target concatenated, each pair's query
and target by offset and length, and each pair's tlen x qlen cells (row
major) at cell_off in the cell arrays (the states, P). Several pairs may
share one query's residues.

Numerics. The MAC DP evaluates `_mac`'s expressions in its order (base + jc
+ c, the running max, run - jc - c, the floor), so the same P gives the same
states, score and first maximum bit for bit in both versions. The kernels'
partition function keeps the row scaling (the row's zm maximum, floored at
1e-37, its log added to the offset as the plain version adds it; the three
divisions a cell give the division's bits, from one reciprocal a row) and
log zm + offset and P's expression as the plain version rounds them, but
takes the in-row scan of ze in another order than XLA's and the logsumexp
of log zm_f online, a row at a time (its terms exp(log zm_f - R) for a
reference R that moves with the offsets, summed in f64); P agrees to a
relative 1e-4 (f32 rounding through a log of a few hundred;
tests/test_torch_fwbw.py).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

FLT_MIN_EXP = -125.0
STOP, M, I, D = 0, 1, 2, 3
# the kernel's limits: a query (the columns) of at most MAX_Q residues, a
# substitution matrix of at most MAX_ALPHA letters
MAX_Q = 16384
MAX_ALPHA = 32
# the launch plan (csrc/fwbw.cu): a warp takes a pair whose query has at
# most WARP_COLS residues (8, 12 or 16 columns a lane); a longer one takes
# a block of wb warps, 8 columns a lane while the launch's longest such
# query has at most 2,048 residues, 16 up to BLOCK_WARPS[KMAX] warps (4,096
# residues), and past that 32 (KMAX_WIDE) up to BLOCK_WARPS[KMAX_WIDE]; a
# block holds WARPS_PER_BLOCK warp-form pairs, or as many as a block-form
# block's warps
WARP_COLS = 512
KMAX, KMAX_WIDE = 16, 32
BLOCK_WARPS = {KMAX: 8, KMAX_WIDE: 16}
WARPS_PER_BLOCK = 4


@dataclass
class PairBatch:
    """Ragged (query, target) pairs on one device (see the module
    docstring): q_res, t_res (n,) uint8; q_off, t_off, cell_off (B,) int64;
    q_len, t_len (B,) int32; n_cells and max_q host ints; plan the kernels'
    LaunchPlan, built by make_pairs from its host lengths (None past MAX_Q,
    where the kernels raise)."""
    q_res: torch.Tensor
    q_off: torch.Tensor
    q_len: torch.Tensor
    t_res: torch.Tensor
    t_off: torch.Tensor
    t_len: torch.Tensor
    cell_off: torch.Tensor
    n_cells: int
    max_q: int
    plan: "LaunchPlan"

    @property
    def size(self):
        return self.q_len.shape[0]

    @property
    def device(self):
        return self.q_res.device


def make_pairs(queries, targets, pair_q, pair_t, device):
    """A PairBatch of pairs (queries[pair_q[b]], targets[pair_t[b]]): numpy
    arrays of residue codes, each query and target stored once."""
    def cat(seqs):
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        off = np.zeros(len(seqs), dtype=np.int64)
        off[1:] = np.cumsum(lens)[:-1]
        res = (np.concatenate(seqs).astype(np.uint8) if len(seqs)
               else np.zeros(0, np.uint8))
        return res, off, lens

    q_res, q_off, q_lens = cat(queries)
    t_res, t_off, t_lens = cat(targets)
    pair_q = np.asarray(pair_q, dtype=np.int64)
    pair_t = np.asarray(pair_t, dtype=np.int64)
    ql, tl = q_lens[pair_q], t_lens[pair_t]
    cells = ql * tl
    cell_off = np.zeros(len(cells), dtype=np.int64)
    cell_off[1:] = np.cumsum(cells)[:-1]

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return PairBatch(
        q_res=dev(q_res, torch.uint8), q_off=dev(q_off[pair_q], torch.int64),
        q_len=dev(ql, torch.int32), t_res=dev(t_res, torch.uint8),
        t_off=dev(t_off[pair_t], torch.int64), t_len=dev(tl, torch.int32),
        cell_off=dev(cell_off, torch.int64), n_cells=int(cells.sum()),
        max_q=int(ql.max()) if len(ql) else 0,
        plan=(launch_plan(ql, tl, device) if not len(ql)
              or int(ql.max()) <= MAX_Q else None))


@dataclass
class LaunchPlan:
    """The kernels' plan of a batch: order (B,) int32 lists the pairs, the
    first n_block of them a block of wb warps each, the rest a warp each,
    wb to a block; kmax the columns a lane holds at most (16 or 32);
    blocks the launch's blocks (a direction); order_dev the order on the
    batch's device."""
    order: np.ndarray
    n_block: int
    wb: int
    kmax: int
    blocks: int
    warp_cols: int = WARP_COLS
    order_dev: torch.Tensor = None

    def forms(self):
        """Pairs by form, and the block form's warps."""
        return dict(warp=len(self.order) - self.n_block,
                    block=self.n_block, block_warps=self.wb
                    if self.n_block else 0, kmax=self.kmax,
                    warp_cols=self.warp_cols)


def launch_plan(q_len, t_len, device=None):
    """The launch plan of pairs of these lengths (host arrays): a pair whose
    query has at most WARP_COLS residues to a warp, a longer one to a block
    of wb warps, enough for the longest such query at 8, 16 or 32 columns a
    lane (see WARP_COLS); within each form the pairs by target length,
    longest first (then by query length), so that the longest chains of
    rows start first. Given a device, the order is copied there too."""
    q_len = np.asarray(q_len, dtype=np.int64)
    t_len = np.asarray(t_len, dtype=np.int64)
    if len(q_len) and int(q_len.max()) > MAX_Q:
        raise ValueError(f"fwbw: the kernel takes queries of at most {MAX_Q} "
                         f"residues, got {int(q_len.max())}")
    long_q = q_len > WARP_COLS

    def by_target(idx):
        return idx[np.lexsort((-q_len[idx], -t_len[idx]))]

    blocks = by_target(np.flatnonzero(long_q))
    warps = by_target(np.flatnonzero(~long_q))
    longest = int(q_len[blocks].max()) if len(blocks) else 0
    kmax = KMAX if longest <= BLOCK_WARPS[KMAX] * 32 * KMAX else KMAX_WIDE
    lane_cols = 8 if longest <= BLOCK_WARPS[KMAX] * 32 * 8 else kmax
    wb = -(-longest // (32 * lane_cols)) if len(blocks) else WARPS_PER_BLOCK
    order = np.concatenate([blocks, warps]).astype(np.int32)
    return LaunchPlan(order=order, n_block=len(blocks), wb=wb, kmax=kmax,
                      blocks=len(blocks) + -(-len(warps) // wb),
                      warp_cols=WARP_COLS,
                      order_dev=None if device is None
                      else torch.from_numpy(order).to(device))


def constants(go, ge, temp, mact):
    """The f32 constants both versions use, as the JAX package rounds them:
    e^{go/T}, e^{ge/T} (float64, then f32), mact and mact/2."""
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    return dict(ego=f32(np.exp(go / temp)), ege=f32(np.exp(ge / temp)),
                temp=f32(temp), m=f32(mact), c=f32(mact * 0.5))


def _check(pairs, mat, p_in):
    if not isinstance(pairs, PairBatch):
        raise TypeError("pairs must be a PairBatch")
    dev = pairs.device
    spec = (("q_res", torch.uint8), ("q_off", torch.int64),
            ("q_len", torch.int32), ("t_res", torch.uint8),
            ("t_off", torch.int64), ("t_len", torch.int32),
            ("cell_off", torch.int64))
    for name, dtype in spec:
        t = getattr(pairs, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"pairs.{name} must be a contiguous {dtype} "
                             f"tensor on {dev}")
    if (mat.device != dev or mat.dtype != torch.float32 or mat.dim() != 2
            or mat.shape[0] != mat.shape[1] or not mat.is_contiguous()):
        raise ValueError(f"mat must be a contiguous square float32 tensor "
                         f"on {dev}")
    if p_in is not None and (p_in.device != dev
                             or p_in.dtype != torch.float32
                             or p_in.shape != (pairs.n_cells,)
                             or not p_in.is_contiguous()):
        raise ValueError(f"p_in must be a contiguous ({pairs.n_cells},) "
                         f"float32 tensor on {dev}")


def _padded(pairs, reverse):
    """(B, Tm) target and (B, Qm) query codes (reversed within each real
    length if reverse), their validity masks and the lengths, as int64."""
    ql, tl = pairs.q_len.long(), pairs.t_len.long()
    dev = pairs.device
    tm = int(tl.max()) if pairs.size else 0
    qm = int(ql.max()) if pairs.size else 0

    def gather(res, off, lens, width):
        pos = torch.arange(width, device=dev)[None, :]
        valid = pos < lens[:, None]
        idx = (lens[:, None] - 1 - pos) if reverse else pos
        idx = torch.where(valid, idx, 0)
        codes = res[(off[:, None] + idx).clamp(max=max(res.numel() - 1, 0))]
        return torch.where(valid, codes.long(), 0), valid

    t, tv = gather(pairs.t_res, pairs.t_off, tl, tm)
    q, qv = gather(pairs.q_res, pairs.q_off, ql, qm)
    return t, tv, q, qv, tl, ql


def _scores(mat, t, tv, q, qv):
    """(B, Tm, Qm) substitution scores, FLT_MIN_EXP off the real region."""
    s = mat[t[:, :, None], q[:, None, :]]
    return torch.where(tv[:, :, None] & qv[:, None, :], s,
                       torch.tensor(FLT_MIN_EXP, dtype=torch.float32,
                                    device=s.device))


def _linear_scan(a, b):
    """x[j] = a[j] x[j-1] + b[j] with x[-1] = 0 along dim 1, by doubling
    (Hillis-Steele); the combination is the JAX package's (x0 y0,
    y0 x1 + y1)."""
    a, b = a.clone(), b.clone()
    n = a.shape[1]
    d = 1
    while d < n:
        pa, pb = a[:, :-d], b[:, :-d]
        na = a[:, d:] * pa
        nb = a[:, d:] * pb + b[:, d:]
        a = torch.cat([a[:, :d], na], 1)
        b = torch.cat([b[:, :d], nb], 1)
        d *= 2
    return b


def _logzm_plain(S, tl, ql, k):
    """One direction of the partition function on (B, Tm, Qm) scores: log
    zm (-inf off the real region and where zm is 0), as `_fwbw_logzm`."""
    B, T, Q = S.shape
    dev = S.device
    f32 = torch.float32
    zm = torch.zeros(B, Q, dtype=f32, device=dev)
    ze = torch.zeros_like(zm)
    zf = torch.zeros_like(zm)
    off = torch.zeros(B, dtype=f32, device=dev)
    zcol = torch.zeros(B, 1, dtype=f32, device=dev)
    cols_ok = torch.arange(Q, device=dev)[None, :] < ql[:, None]
    a = torch.full((B, Q), k["ege"], dtype=f32, device=dev)
    a[:, 0] = 0.0
    out = torch.empty(B, T, Q, dtype=f32, device=dev)
    neg_inf = torch.tensor(-np.inf, dtype=f32, device=dev)
    for i in range(T):
        es = torch.exp(S[:, i] / k["temp"])
        one = torch.exp(-off)[:, None]
        zm_c = (torch.cat([zcol, zm[:, :-1]], 1)
                + torch.cat([zcol, ze[:, :-1]], 1)
                + torch.cat([zcol, zf[:, :-1]], 1) + one) * es
        valid = i < tl
        rowmax = torch.where(valid, zm_c.amax(1).clamp_min(1e-37),
                             torch.ones_like(off))
        zf = (zm * k["ego"] + zf * k["ege"]) / rowmax[:, None]
        b = torch.cat([zcol, zm_c[:, :-1] * k["ego"]], 1)
        ze = _linear_scan(a, b) / rowmax[:, None]
        zm = zm_c / rowmax[:, None]
        off = off + torch.log(rowmax)
        logrow = torch.where(zm > 0, torch.log(zm) + off[:, None], neg_inf)
        out[:, i] = torch.where(valid[:, None] & cols_ok, logrow, neg_inf)
    return out


def _mac_plain(P, tl, ql, k):
    """`_mac` on (B, Tm, Qm) P: (bt uint8, best, bi, bj), bt's padded cells
    whatever the recurrence left there."""
    B, T, Q = P.shape
    dev = P.device
    f32 = torch.float32
    c, m = k["c"], k["m"]
    cols = torch.arange(Q, device=dev)
    jc = cols.to(f32) * c
    s_prev = torch.zeros(B, Q + 1, dtype=f32, device=dev)
    zcol = torch.zeros(B, 1, dtype=f32, device=dev)
    best = torch.full((B,), -np.inf, dtype=f32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bj = torch.zeros(B, dtype=torch.int32, device=dev)
    bt = torch.empty(B, T, Q, dtype=torch.uint8, device=dev)
    neg_inf = torch.tensor(-np.inf, dtype=f32, device=dev)
    for i in range(T):
        p = P[:, i]
        term1 = p - m
        term2 = s_prev[:, :-1] + p - m
        term4 = s_prev[:, 1:] - c
        base = torch.maximum(torch.maximum(term1, term2), term4)
        shifted = base + jc + c
        run = torch.cummax(shifted, 1).values
        s_curr = torch.maximum(run - jc - c, -jc - c)
        s_full = torch.cat([zcol, s_curr], 1)
        term3 = s_full[:, :-1] - c
        st = torch.where(term1 > term2, STOP, M).to(torch.uint8)
        cur = torch.maximum(term1, term2)
        st = torch.where(term3 > cur, I, st).to(torch.uint8)
        cur = torch.maximum(cur, term3)
        st = torch.where(term4 > cur, D, st).to(torch.uint8)
        cur = torch.maximum(cur, term4)
        valid = (i < tl)[:, None] & (cols[None, :] < ql[:, None])
        masked = torch.where(valid, cur, neg_inf)
        rmax = masked.amax(1)
        rj = torch.argmax(masked, 1).to(torch.int32)   # the first maximum
        upd = rmax > best
        best = torch.where(upd, rmax, best)
        bi = torch.where(upd, i + 1, bi).to(torch.int32)
        bj = torch.where(upd, rj + 1, bj).to(torch.int32)
        bt[:, i] = st
        s_prev = s_full
    return bt, best, bi, bj


def _ragged(x, tv, qv):
    """(B, Tm, Qm) -> the real cells of each pair, row major, pair after
    pair (the cell_off layout)."""
    return x[tv[:, :, None] & qv[:, None, :]]


def _unragged(flat, tv, qv, fill):
    mask = tv[:, :, None] & qv[:, None, :]
    out = torch.full(mask.shape, fill, dtype=flat.dtype, device=flat.device)
    out[mask] = flat
    return out


def fwbw_plain(pairs, mat, go=-10.0, ge=-2.0, temp=1.0, mact=0.035,
               p_in=None, want_p=False):
    """Plain version of fwbw: the JAX package's algorithm row by row in
    PyTorch, on the pairs' device, padded to the batch's longest target and
    query. Same outputs as fwbw."""
    _check(pairs, mat, p_in)
    k = constants(go, ge, temp, mact)
    t, tv, q, qv, tl, ql = _padded(pairs, reverse=False)
    S = _scores(mat, t, tv, q, qv)
    if p_in is None:
        logf = _logzm_plain(S, tl, ql, k)
        tr, tvr, qr, qvr, _, _ = _padded(pairs, reverse=True)
        logb_r = _logzm_plain(_scores(mat, tr, tvr, qr, qvr), tl, ql, k)
        # back to forward coordinates: (i, j) <- (tlen-1-i, qlen-1-j)
        B, T, Q = S.shape
        ii = (tl[:, None] - 1 - torch.arange(T, device=S.device)).clamp(0)
        jj = (ql[:, None] - 1 - torch.arange(Q, device=S.device)).clamp(0)
        logb = logb_r[torch.arange(B, device=S.device)[:, None, None],
                      ii[:, :, None], jj[:, None, :]]
        mx = logf.amax((1, 2))
        lse = mx + torch.log(torch.exp(logf - mx[:, None, None]).sum((1, 2)))
        logp = logf + logb - S / k["temp"] - lse[:, None, None]
        mask = tv[:, :, None] & qv[:, None, :]
        logp = torch.where(torch.isfinite(logp) & mask, logp,
                           torch.tensor(-np.inf, dtype=torch.float32,
                                        device=S.device))
        P = torch.exp(logp)
    else:
        P = _unragged(p_in, tv, qv, 0.0)
    bt, best, bi, bj = _mac_plain(P, tl, ql, k)
    out = dict(bt=_ragged(bt, tv, qv), score=best, bi=bi, bj=bj,
               maxp=P.amax((1, 2)) if pairs.size else best.clone())
    if want_p:
        out["p"] = _ragged(P, tv, qv)
    return out


def fwbw(pairs, mat, go=-10.0, ge=-2.0, temp=1.0, mact=0.035, p_in=None,
         want_p=False):
    """B5 on a PairBatch: dict of bt ((n_cells,) uint8 MAC states), score,
    maxp ((B,) f32: the MAC score and max P), bi, bj ((B,) int32: the
    1-based first maximum cell), and p ((n_cells,) f32) if want_p. With
    p_in ((n_cells,) f32) the MAC runs on that P and the partition function
    is not computed. mat: the (A, A) f32 substitution matrix, A <= 32."""
    _check(pairs, mat, p_in)
    dev = pairs.device
    if dev.type == "cpu":
        return fwbw_plain(pairs, mat, go, ge, temp, mact, p_in, want_p)
    if dev.type != "cuda":
        raise ValueError(f"fwbw: no kernel for device {dev}")
    if pairs.max_q > MAX_Q or mat.shape[0] > MAX_ALPHA:
        raise ValueError(f"fwbw: the kernel takes queries of at most {MAX_Q} "
                         f"residues and at most {MAX_ALPHA} letters, got "
                         f"{pairs.max_q} and {mat.shape[0]}")
    k = constants(go, ge, temp, mact)
    B, n = pairs.size, pairs.n_cells
    f32 = torch.float32
    out = dict(bt=torch.empty(n, dtype=torch.uint8, device=dev),
               score=torch.empty(B, dtype=f32, device=dev),
               bi=torch.empty(B, dtype=torch.int32, device=dev),
               bj=torch.empty(B, dtype=torch.int32, device=dev),
               maxp=torch.empty(B, dtype=f32, device=dev))
    if want_p:
        out["p"] = torch.empty(n, dtype=f32, device=dev)
    if B == 0:
        return out
    plan = pairs.plan
    lf = lb = lse = None
    if p_in is None:
        lf = torch.empty(n, dtype=f32, device=dev)
        lb = torch.empty(n, dtype=f32, device=dev)
        lse = torch.empty(B, dtype=f32, device=dev)
    lib = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fwbw_launch(
            ptr(pairs.q_res), ptr(pairs.q_off), ptr(pairs.q_len),
            ptr(pairs.t_res), ptr(pairs.t_off), ptr(pairs.t_len),
            ptr(pairs.cell_off), B, ptr(plan.order_dev), plan.n_block, plan.wb,
            plan.kmax, ptr(mat), mat.shape[0], k["ego"], k["ege"], k["temp"],
            k["m"], k["c"], ptr(lf), ptr(lb), ptr(lse), ptr(p_in),
            ptr(out.get("p")),
            ptr(out["bt"]), ptr(out["score"]), ptr(out["bi"]),
            ptr(out["bj"]), ptr(out["maxp"]), stream)
    if err != 0:
        raise RuntimeError(f"fwbw kernel launch failed: CUDA error {err}")
    fwbw.launches += 1
    return out


fwbw.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("fwbw")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fwbw_launch.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, p,
                                    i, f, f, f, f, f, p, p, p, p, p, p, p, p,
                                    p, p, p]
        lib.fwbw_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def backtrace(bt, cell_off, q_len, bi, bj, t_res=None, t_off=None,
              q_res=None, q_off=None):
    """The MAC backtrace of every pair from the host's states, walked as
    `fwbw_align_batch` walks it (all pairs a step at a time): per pair the
    cigar ('M'/'I'/'D'), q/t start and end (0-based, inclusive) and, given
    the residues (numpy), the number of identical aligned residues.
    bt: (n_cells,) uint8; the rest (B,) numpy arrays."""
    B = len(bi)
    i = np.asarray(bi, dtype=np.int64).copy()
    j = np.asarray(bj, dtype=np.int64).copy()
    cell_off = np.asarray(cell_off, dtype=np.int64)
    q_len = np.asarray(q_len, dtype=np.int64)
    q_end, t_end = j - 1, i - 1
    q_start, t_start = q_end.copy(), t_end.copy()
    ids = np.zeros(B, dtype=np.int64)
    steps = []                      # (pairs, their states) a step
    active = np.flatnonzero((i > 0) & (j > 0))
    while len(active):
        a = active
        st = bt[cell_off[a] + (i[a] - 1) * q_len[a] + (j[a] - 1)]
        steps.append((a, st))
        mm = st == M
        i[a[mm | (st == D)]] -= 1
        j[a[mm | (st == I)]] -= 1
        am = a[mm]
        q_start[am], t_start[am] = j[am], i[am]
        if t_res is not None and len(am):
            ids[am] += (t_res[t_off[am] + i[am]]
                        == q_res[q_off[am] + j[am]])
        keep = (st != STOP) & (i[a] > 0) & (j[a] > 0)
        active = a[keep]
    # each pair's states in walk order, as rows of one array
    n_steps = np.zeros(B, dtype=np.int64)
    hist = np.zeros((B, len(steps)), dtype=np.uint8)
    for s, (a, st) in enumerate(steps):
        walk = st != STOP
        hist[a[walk], s] = st[walk]
        n_steps[a[walk]] += 1
    letters = bytes.maketrans(b"\x01\x02\x03", b"MID")
    cigars = []
    for b in range(B):
        row = hist[b, :n_steps[b]]
        # trailing I/D of the walk (the alignment's start) are dropped
        mpos = np.flatnonzero(row == M)
        row = row[:mpos[-1] + 1] if len(mpos) else row[:0]
        cigars.append(row[::-1].tobytes().translate(letters).decode())
    return dict(cigar=cigars, q_start=q_start, q_end=q_end, t_start=t_start,
                t_end=t_end, identities=ids)
