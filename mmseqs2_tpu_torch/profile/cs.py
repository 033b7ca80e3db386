"""Context-specific pseudocounts (CSProfile / ContextLibrary).

Port of mmseqs2_tpu/profile/cs.py. Reference: src/commons/CSProfile.cpp
  - ContextLibrary::read parses the CRF text format (kScale=1000 fixed-point
    context/pseudocount weights in HH alphabet order, ProfileStates.h:108-111)
    and softmax-normalizes the pseudocount emission of each context state.
  - CSProfile::computeProfile scores every context k at every position i
    (bias_k + sum_j W_k[j, seq[i+j-center]]), softmaxes over k, and mixes the
    contexts' pseudocount emissions into the per-position amino-acid
    distribution, then admixes with the sequence one-hot:
        profile_i = tau * P(a|X_i) + (1-tau) * onehot(seq_i).

The per-position context scores are one product, scores = X @ W^T + b, with
X the (L, wlen*21) stacked one-hot window. For a real library (K >= 512
contexts) it runs as one f32 `torch.matmul` on the device of get_device()
(the card unless the CPU was requested; TF32 must stay off), L padded to 64
and doubling; a smaller library keeps the numpy product, as the JAX package
does. STATS counts the device products.

The reference embeds the K4000.crf library via git-lfs, which is absent
from this snapshot (a placeholder file ships instead), so byte parity is
impossible even against a freshly built reference binary. We therefore
default to a small synthetic library derived from the substitution matrix
(single-residue contexts whose emissions are the conditional substitution
probabilities P(a|b)) and accept any real .crf via `load_crf`.
"""

import functools

import numpy as np
import torch

from ..device import get_device

K_SCALE = 1000.0
# libraries of at least this many contexts take the device product
DEVICE_MIN_CONTEXTS = 512

# the device products: launches (one torch.matmul a sequence), the rows they
# computed (L padded) and the real ones, and on the card the product's
# milliseconds by CUDA events
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update(products=0, rows_padded=0, rows=0, product_ms=0.0)


reset_stats()
# hh -> mmseqs amino-acid order (ProfileStates::hh2mmseqsAAorder)
HH2MM = [0, 14, 11, 2, 1, 13, 3, 5, 6, 7, 9, 8, 10, 4, 12, 15, 16, 18,
         19, 17]


class ContextLibrary:
    """K context states over windows of length wlen (odd), alphabet 20."""

    def __init__(self, weights, biases, pc_weights):
        # weights: (K, wlen, 21) — column 20 (X) fixed 0 like the reference
        self.weights = np.asarray(weights, np.float32)
        self.biases = np.asarray(biases, np.float32)
        K, wlen, _ = self.weights.shape
        self.size = K
        self.wlen = wlen
        self.center = (wlen - 1) // 2
        pcw = np.asarray(pc_weights, np.float64)      # (K, 20)
        mx = pcw.max(axis=1, keepdims=True)
        e = np.exp(pcw - mx)
        self.pc = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def load_crf(text: str) -> ContextLibrary:
    """Parse the reference CRF serialization (ContextLibrary::read)."""
    lines = iter(text.splitlines())

    def next_line():
        return next(lines)

    first = next_line()
    if not first.startswith("CRF"):
        raise ValueError("stream does not start with class id 'CRF'")
    size = int(next_line().split()[1])
    wlen = int(next_line().split()[1])
    weights = np.zeros((size, wlen, 21), np.float32)
    biases = np.zeros((size,), np.float32)
    pcw = np.zeros((size, 20), np.float64)
    for k in range(size):
        line = next_line()
        while not line.startswith("CrfState"):
            line = next_line()
        line = next_line()
        if line.startswith("NAME"):
            line = next_line()
        assert line.startswith("BIAS")
        biases[k] = float(line.split()[1])
        leng = int(next_line().split()[1])
        alph = int(next_line().split()[1])
        if alph != 20:
            raise ValueError("CRF alphabet size must be 20")
        next_line()  # alphabet header
        line = next_line()
        while not line.startswith("//"):
            parts = line.split()
            if parts[0] == "PC":
                for a in range(20):
                    pcw[k, HH2MM[a]] = int(parts[1 + a]) / K_SCALE
            else:
                i = int(parts[0]) - 1
                for a in range(20):
                    weights[k, i, HH2MM[a]] = int(parts[1 + a]) / K_SCALE
            line = next_line()
        if leng != wlen:
            raise ValueError("CRF state length mismatch")
    return ContextLibrary(weights, biases, pcw)


def dump_crf(lib: ContextLibrary, pc_weights=None) -> str:
    """Serialize a library back to the reference CRF text format."""
    out = [f"CRF", f"SIZE\t{lib.size}", f"LENG\t{lib.wlen}"]
    mm2hh = np.argsort(HH2MM)
    if pc_weights is None:
        pc_weights = np.log(np.maximum(lib.pc, 1e-30))
    for k in range(lib.size):
        out.append("CrfState")
        out.append(f"NAME\tK{k}")
        out.append(f"BIAS\t{lib.biases[k]:.6f}")
        out.append(f"LENG\t{lib.wlen}")
        out.append("ALPH\t20")
        out.append("\t" + "\t".join("ACDEFGHIKLMNPQRSTVWY"))
        for i in range(lib.wlen):
            row = [str(i + 1)]
            for a in range(20):
                row.append(str(int(round(lib.weights[k, i, HH2MM[a]]
                                         * K_SCALE))))
            out.append("\t".join(row))
        row = ["PC"]
        for a in range(20):
            row.append(str(int(round(pc_weights[k][HH2MM[a]] * K_SCALE))))
        out.append("\t".join(row))
        out.append("//")
    return "\n".join(out) + "\n"


@functools.lru_cache(maxsize=4)
def synthetic_library(submat_name: str = "blosum62.out") -> ContextLibrary:
    """Default library: 20 single-residue contexts; emission of context b is
    the substitution conditional P(a|b). Context pseudocounts then behave
    like substitution-matrix pseudocounts with context weighting."""
    from ..data.submat import get_submat

    sm = get_submat(submat_name, 2.0, 0.0)
    prob = np.asarray(sm.prob_matrix, np.float64)[:20, :20]
    pback = np.asarray(sm.pback, np.float64)[:20]
    cond = prob / pback[None, :]                       # P(a|b)
    cond = cond / cond.sum(axis=0, keepdims=True)
    wlen = 13
    center = (wlen - 1) // 2
    weights = np.zeros((20, wlen, 21), np.float32)
    for k in range(20):
        weights[k, center, k] = 5.0
    pcw = np.log(np.maximum(cond.T, 1e-30))            # (K=b, a)
    return ContextLibrary(weights, np.zeros(20), pcw)


def _device_weights(lib: ContextLibrary, dev):
    """The library's W^T (wlen*21, K) and biases on `dev`, uploaded once."""
    cache = lib.__dict__.setdefault("_device", {})
    if dev not in cache:
        Wf = lib.weights.reshape(lib.size, lib.wlen * 21)
        cache[dev] = (torch.from_numpy(np.ascontiguousarray(Wf.T)).to(dev),
                      torch.from_numpy(lib.biases).to(dev))
    return cache[dev]


def context_scores(Xf: np.ndarray, lib: ContextLibrary) -> np.ndarray:
    """(L, K) f32 context scores Xf @ W^T + b as one torch.matmul on the
    device of get_device(), L padded to 64 and doubling (the JAX package's
    buckets). On the card TF32 must be off: the product is held to the
    CPU's f32 result."""
    dev = get_device()
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the context-score product needs full f32: "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    L = Xf.shape[0]
    Lp = 64
    while Lp < L:
        Lp *= 2
    Xp = np.zeros((Lp, Xf.shape[1]), np.float32)
    Xp[:L] = Xf
    Wt, b = _device_weights(lib, dev)
    x = torch.from_numpy(Xp).to(dev)
    ev = None
    if dev.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    scores = torch.matmul(x, Wt) + b[None, :]
    if ev is not None:
        ev[1].record()
    out = scores[:L].cpu().numpy()
    if ev is not None:
        STATS["product_ms"] += ev[0].elapsed_time(ev[1])
    STATS["products"] += 1
    STATS["rows_padded"] += Lp
    STATS["rows"] += L
    return out


def compute_sequence_cs(num_seq, lib: ContextLibrary, tau: float = 0.9,
                        device_product: bool = True):
    """CSProfile::computeSequenceCs — per-position 20-dim probabilities.

    num_seq: (L,) residue indices 0..20 (X=20 scores 0 in every context).
    device_product: a library of DEVICE_MIN_CONTEXTS or more contexts
    computes its scores by context_scores (False: the numpy product).
    """
    L = len(num_seq)
    onehot = np.zeros((L, 21), np.float32)
    onehot[np.arange(L), np.clip(num_seq, 0, 20)] = 1.0
    c = lib.center
    # X[i, j, :] = onehot(seq[i + j - center]), zero outside the sequence
    X = np.zeros((L, lib.wlen, 21), np.float32)
    for j in range(lib.wlen):
        off = j - c
        lo, hi = max(0, -off), min(L, L - off)
        X[lo:hi, j] = onehot[lo + off:hi + off]
    Xf = X.reshape(L, lib.wlen * 21)
    if device_product and lib.size >= DEVICE_MIN_CONTEXTS:
        scores = context_scores(Xf, lib)
    else:
        Wf = lib.weights.reshape(lib.size, lib.wlen * 21)
        scores = Xf @ Wf.T + lib.biases[None, :]       # (L, K)
    mx = scores.max(axis=1, keepdims=True)
    e = np.exp((scores - mx).astype(np.float64))
    ppi = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    p = ppi @ lib.pc                                   # (L, 20)
    p = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-30)
    prof = tau * p
    idx = np.clip(num_seq, 0, 20)
    sel = idx < 20
    prof[np.arange(L)[sel], idx[sel]] += (1.0 - tau)
    prof = prof / np.maximum(prof.sum(axis=1, keepdims=True), 1e-30)
    return prof
