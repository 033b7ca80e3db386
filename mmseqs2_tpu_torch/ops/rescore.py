"""Ungapped diagonal rescore of prefilter candidates (exact scores).

Port of the k-mer prefilter's rescorer (mmseqs2_tpu/prefilter:
pallas_rescore.py:_kernel, device_stages.make_rescore and
make_rescore_from_letters; reference UngappedAlignment.cpp): for every valid
candidate (query qid, target id, diagonal) the score of the best ungapped
segment on that diagonal,

    d  = the low 16 bits of diag read as signed; qs = max(d, 0); ts = max(-d, 0)
    n  = max(min(t_len[id] - ts, q_len[qid] - qs), 0)
    s_l = submat[q[qid, qs + l], t_cat[t_off[id] + ts + l]] + corr[qid, qs + l]
    out = max(0, max_l (c_l - min(0, min_{k<l} c_k))),  c = cumsum(s)

and 0 for an invalid candidate or an empty window. The score is exact
(int32); the caller takes min(score, 255) where the reference caps.

  diag_rescore        the wrapper: CUDA tensors go to the hand-written kernel
                      (csrc/rescore.cu, built at first use), CPU tensors to the
                      plain version; anything else raises.
                      `diag_rescore.launches` counts kernel launches.
  diag_rescore_plain  the same function in plain PyTorch (gather, cumsum,
                      cummin), on any device.

Tensors: cqid, cid, cdiag (C,) int32 and cvalid (C,) bool; t_cat (R,) int8
target letters, t_off (T,) int64 and t_len (T,) int32; q_pad (B, Lq) uint8
query letters and corr (B, Lq) int8 bias correction; submat (A, A) int32 with
A <= 32; q_len (B,) int32. Slots with cvalid False may hold any qid and id.
"""

import ctypes

import torch

MAX_ALPHA = 32
PLAIN_ROWS = 2048       # candidates per gather block of the plain version

_SPEC = (("cqid", torch.int32, 1), ("cid", torch.int32, 1),
         ("cdiag", torch.int32, 1), ("cvalid", torch.bool, 1),
         ("t_cat", torch.int8, 1), ("t_off", torch.int64, 1),
         ("t_len", torch.int32, 1), ("q_pad", torch.uint8, 2),
         ("corr", torch.int8, 2), ("submat", torch.int32, 2),
         ("q_len", torch.int32, 1))


def _check(args):
    dev = args[0].device
    for (name, dtype, dim), t in zip(_SPEC, args):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cqid on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dimension(s), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cqid, cid, cdiag, cvalid, _, t_off, t_len, q_pad, corr, submat, q_len = \
        args
    n = cqid.shape[0]
    for name, t in (("cid", cid), ("cdiag", cdiag), ("cvalid", cvalid)):
        if t.shape[0] != n:
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if t_off.shape != t_len.shape:
        raise ValueError("t_off and t_len must have one entry per target")
    if corr.shape != q_pad.shape or q_len.shape[0] != q_pad.shape[0]:
        raise ValueError("q_pad, corr must be (B, Lq) and q_len (B,)")
    if submat.shape[0] != submat.shape[1] or not \
            1 <= submat.shape[0] <= MAX_ALPHA:
        raise ValueError(f"submat must be (A, A) with A <= {MAX_ALPHA}, got "
                         f"{tuple(submat.shape)}")


def diag_rescore_plain(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad,
                       corr, submat, q_len):
    """Plain version of diag_rescore: valid candidates are gathered in
    blocks of PLAIN_ROWS, each as wide as its longest window."""
    dev = cqid.device
    out = torch.zeros(cqid.shape[0], dtype=torch.int32, device=dev)
    sel = torch.nonzero(cvalid).flatten()
    if sel.numel() == 0:
        return out
    qid = cqid[sel].long()
    tid = cid[sel].long()
    d = ((cdiag[sel].long() + 0x8000) & 0xFFFF) - 0x8000     # signed 16 bits
    qs = d.clamp(min=0)
    ts = (-d).clamp(min=0)
    n = torch.minimum(t_len[tid].long() - ts,
                      q_len[qid].long() - qs).clamp(min=0)
    base = t_off[tid] + ts
    lq = q_pad.shape[1]
    alpha = submat.shape[1]
    sub_flat = submat.reshape(-1).long()
    q_flat = q_pad.reshape(-1)
    corr_flat = corr.reshape(-1)
    res = torch.zeros(sel.numel(), dtype=torch.int64, device=dev)
    for lo in range(0, sel.numel(), PLAIN_ROWS):
        hi = min(lo + PLAIN_ROWS, sel.numel())
        n_k = n[lo:hi]
        ln = int(n_k.max())
        if ln == 0:
            continue
        l = torch.arange(ln, device=dev)[None, :]
        active = l < n_k[:, None]
        tc = t_cat[torch.where(active, base[lo:hi, None] + l, 0)].long()
        qrow = qid[lo:hi, None] * lq + torch.where(
            active, qs[lo:hi, None] + l, 0)
        s = sub_flat[q_flat[qrow].long() * alpha + tc] + corr_flat[qrow]
        s = torch.where(active, s, 0)
        cums = torch.cumsum(s, 1)
        prev_min = torch.cat(
            [torch.zeros_like(cums[:, :1]),
             torch.cummin(cums, 1).values[:, :-1]], 1).clamp(max=0)
        run = torch.where(active, cums - prev_min, 0)
        res[lo:hi] = run.max(1).values
    out[sel] = res.clamp(min=0).to(torch.int32)
    return out


def _launch_kernel(args):
    cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr, submat, \
        q_len = args
    dev = cqid.device
    n = cqid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.diag_rescore_launch(
            cqid.data_ptr(), cid.data_ptr(), cdiag.data_ptr(),
            cvalid.data_ptr(), n, t_cat.data_ptr(), t_off.data_ptr(),
            t_len.data_ptr(), q_pad.data_ptr(), corr.data_ptr(),
            q_pad.shape[1], q_len.data_ptr(), submat.data_ptr(),
            submat.shape[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"diag_rescore kernel launch failed: CUDA error "
                           f"{err}")
    diag_rescore.launches += 1
    return out


def diag_rescore(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr,
                 submat, q_len):
    """Exact best ungapped diagonal score per candidate, (C,) int32 on the
    inputs' device (see the module docstring for the tensors)."""
    args = (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, q_pad, corr,
            submat, q_len)
    _check(args)
    dev = cqid.device
    if dev.type == "cpu":
        return diag_rescore_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"diag_rescore: no kernel for device {dev}")
    return _launch_kernel(args)


diag_rescore.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("rescore")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.diag_rescore_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i,
                                            p, p, i, p, p]
        lib.diag_rescore_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
