"""Posting expansion of the k-mer prefilter's CSR lookups (B6).

Port of the expansion of the JAX package's device candidate stage
(mmseqs2_tpu/prefilter/device_stages.py: seg_expand :47 over fast_cumsum
:30, and the gathers of stage_candidates :248-255), which the prefilter
runs on the device past the packed sort key (more than 2^22 targets) and in
target-split mode. For K CSR triples (a posting list's first entry
`starts`, its length `counts`, the k-mer's query position `qpos` and its
query `qid` in the flush) and their inclusive running sum `cum`, expansion
e < total = cum[-1] is entry ent = starts[t] + e - (cum[t] - counts[t]) of
the triple t with cum[t - 1] <= e < cum[t]:

    key[e]  = qid[t] << 32 | entries_seq[ent]          int64
    diag[e] = (qpos[t] - entries_pos[ent]) & 0xFFFF     the u16 bits, int16

in expansion order (triple-major, then position in the list); the pad
slots [total, cap) take key INT64_MAX and diag 0, and expansions past cap
are dropped. The int64 key orders as the JAX package's stable two-key
(qid, id) sort (device_stages.sort_dup_packed with shift 32).

  posting_expand        the wrapper: CUDA tensors go to the hand-written
                        kernel (csrc/expand.cu, built at first use), CPU
                        tensors to the plain version; anything else raises.
                        `posting_expand.launches` counts kernel launches.
  posting_expand_plain  the same function in plain PyTorch
                        (repeat_interleave and gathers), on any device.

Tensors: starts (K,) int64, counts, qpos, qid (K,) int32, cum (K,) int64
(torch.cumsum of counts); entries_seq (E,) int32 and entries_pos (E,) int16
holding the u16 positions' bits; total a 0-dim or (1,) int64 tensor on the
same device, cum[-1] (0 when K is 0), read by the kernel on the card so
nothing is read back; cap an int.

starts are int64, not int32 as in the JAX package (whose device index
lives in a TPU's HBM): one split's index on an 80 GB card can pass 2^31
entries.

The kernel's bound is bytes: 6 B in and 10 B out per expansion, and 20 B
in per triple, the least the function needs (starts, qpos, qid and a
32-bit length; the interface's counts and int64 running sum carry 12 B
more, and the kernel reads the running sum, not the counts).
csrc/expand.cu's header has the design: tiles of 1,024 consecutive
expansions; each tile's first and last triple found by 32-ary searches,
four tiles' at once; the tile's triples loaded into shared memory; each
triple's first expansion in the tile marked and one block-wide max-scan
giving every expansion its triple; a warp's loads and stores cover 32
consecutive expansions; no atomics.
"""

import ctypes

import torch

KEY_PAD = torch.iinfo(torch.int64).max

_SPEC = (("starts", torch.int64), ("counts", torch.int32),
         ("qpos", torch.int32), ("qid", torch.int32), ("cum", torch.int64),
         ("entries_seq", torch.int32), ("entries_pos", torch.int16),
         ("total", torch.int64))


def _check(args, cap):
    dev = args[0].device
    for (name, dtype), t in zip(_SPEC, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, starts on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    k = args[0].shape[0]
    for (name, _), t in zip(_SPEC[:5], args[:5]):
        if t.shape != (k,):
            raise ValueError(f"{name} must be ({k},), got {tuple(t.shape)}")
    for (name, _), t in zip(_SPEC[5:7], args[5:7]):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    if args[5].shape != args[6].shape:
        raise ValueError("entries_seq and entries_pos must have one value "
                         "per entry")
    if args[7].numel() != 1 or args[7].dim() > 1:
        raise ValueError(f"total must be 0-dim or (1,), got "
                         f"{tuple(args[7].shape)}")
    if not isinstance(cap, int) or cap < 0:
        raise ValueError(f"cap must be an int >= 0, got {cap!r}")


def posting_expand_plain(starts, counts, qpos, qid, cum, entries_seq,
                         entries_pos, total, cap):
    """Plain version of posting_expand: repeat_interleave and gathers."""
    dev = starts.device
    key = torch.full((cap,), KEY_PAD, dtype=torch.int64, device=dev)
    diag = torch.zeros(cap, dtype=torch.int16, device=dev)
    n = min(int(total.reshape(())), cap)
    if n <= 0:
        return key, diag
    trip = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=dev), counts.long())[:n]
    within = torch.arange(n, device=dev) - (cum[trip] - counts[trip].long())
    ent = starts[trip] + within
    key[:n] = (qid[trip].long() << 32) | (entries_seq[ent].long()
                                          & 0xFFFFFFFF)
    d = (qpos[trip] - (entries_pos[ent].int() & 0xFFFF)) & 0xFFFF
    diag[:n] = (((d + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return key, diag


def posting_expand(starts, counts, qpos, qid, cum, entries_seq, entries_pos,
                   total, cap):
    """(key (cap,) int64, diag (cap,) int16) on the inputs' device (see the
    module docstring)."""
    args = (starts, counts, qpos, qid, cum, entries_seq, entries_pos, total)
    _check(args, cap)
    dev = starts.device
    if dev.type == "cpu":
        return posting_expand_plain(*args, cap)
    if dev.type != "cuda":
        raise ValueError(f"posting_expand: no kernel for device {dev}")
    key = torch.empty(cap, dtype=torch.int64, device=dev)
    diag = torch.empty(cap, dtype=torch.int16, device=dev)
    if cap == 0:
        return key, diag
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.posting_expand_launch(
            starts.data_ptr(), counts.data_ptr(), qpos.data_ptr(),
            qid.data_ptr(), cum.data_ptr(), starts.shape[0],
            entries_seq.data_ptr(), entries_pos.data_ptr(), total.data_ptr(),
            cap, key.data_ptr(), diag.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"posting_expand kernel launch failed: CUDA error "
                           f"{err}")
    posting_expand.launches += 1
    return key, diag


posting_expand.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .kernels import load
        lib = load("expand")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.posting_expand_launch.argtypes = [p, p, p, p, p, i, p, p, p, ll,
                                              p, p, p]
        lib.posting_expand_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
