"""Reduced amino-acid alphabets via maximum-mutual-information merging.

Reference: src/prefiltering/ReducedMatrix.cpp — greedily merge the letter
pair whose merged probability matrix retains the highest mutual information
sum(p_ij * log2(p_ij / (p_i p_j))), repeating until the target alphabet size
(X kept as its own final letter, reconnected through the original X
probabilities).
"""

import numpy as np

from .submat import ANY_BACK, SubstitutionMatrix, get_submat


def _background(p: np.ndarray, contains_x: bool) -> np.ndarray:
    pb = p.sum(axis=1)
    if contains_x:
        pb = pb.copy()
        pb[-1] = ANY_BACK
    return pb


def _mutual_information(p: np.ndarray) -> float:
    pb = _background(p, False)
    with np.errstate(divide="ignore", invalid="ignore"):
        sub = np.log2(p / (pb[:, None] * pb[None, :]))
    return float((p * sub).sum())


def _couple(p: np.ndarray, i: int, j: int) -> np.ndarray:
    """Merge letter j into i (column add + row add, j removed)."""
    q = p.copy()
    q[:, i] += q[:, j]
    q = np.delete(q, j, axis=1)
    q[i, :] += q[j, :]
    q = np.delete(q, j, axis=0)
    return q


class ReducedMatrix:
    """Drop-in with the SubstitutionMatrix interface (sub_matrix, pback,
    alphabet_size, encode) over the reduced alphabet."""

    def __init__(self, base: SubstitutionMatrix, reduced_size: int,
                 bit_factor: float = 2.0):
        orig = base.alphabet_size          # incl. X
        p = base.prob_matrix[: orig - 1, : orig - 1].copy()   # w/o X
        letters = list(base.alphabet[: orig - 1])
        groups = [[a] for a in letters]
        steps = orig - reduced_size
        for _ in range(steps):
            n = p.shape[0]
            best = 0.0
            bi = bj = 0
            for i in range(n):
                for j in range(i + 1, n):
                    info = _mutual_information(_couple(p, i, j))
                    if info > best:
                        best = info
                        bi, bj = i, j
            p = _couple(p, bi, bj)
            letters.pop(bj)
            groups[bi] = groups[bi] + groups.pop(bj)
        self._groups = groups

        self.alphabet_size = reduced_size
        n = reduced_size - 1                # non-X letters
        pb = _background(p, False)
        # reconnect X through the original probabilities
        pb_full = np.zeros(reduced_size)
        prob = np.zeros((reduced_size, reduced_size))
        prob[:n, :n] = p
        pb_r = prob.sum(axis=1)
        pb_r[-1] = ANY_BACK
        # original background (incl X row sums)
        orig_pb = base.prob_matrix.sum(axis=1)
        orig_pb[-1] = ANY_BACK
        orig_a2n = {a: i for i, a in enumerate(base.alphabet)}
        for i, rep_aa in enumerate(letters):
            # probability of (merged letter, X) from the representative's
            # original row — reference uses the representative (num2aa_new)
            oi = orig_a2n[rep_aa]
            pab = base.prob_matrix[oi, orig - 1] / (
                orig_pb[oi] * orig_pb[orig - 1])
            prob[reduced_size - 1, i] = pab * pb_r[i] * pb_r[-1]
            prob[i, reduced_size - 1] = pab * pb_r[-1] * pb_r[i]
        self.prob_matrix = prob
        pb2 = prob.sum(axis=1)
        pb2[-1] = ANY_BACK
        self.pback = pb2.copy()
        self.pback_bg = pb2
        with np.errstate(divide="ignore"):
            sm = np.log2(prob / (pb2[:, None] * pb2[None, :]))
        scaled = bit_factor * sm
        scaled = np.where(np.isfinite(scaled), scaled, -(1 << 14))
        self.sub_matrix = np.where(scaled < 0.0, scaled - 0.5,
                                   scaled + 0.5).astype(np.int16)
        self.sub_matrix_float = sm

        self.alphabet = "".join(letters) + "X"
        self.num2aa = list(self.alphabet)
        self.aa2num = {a: i for i, a in enumerate(self.alphabet)}
        # letter mapping: every original letter maps to its merged class
        self._orig_letters = base.alphabet
        self._class_of = {}
        # reproduce the merge classes by re-running with tracking
        self._enc_table = self._make_table(base)

    def _make_table(self, base) -> np.ndarray:
        groups = self._groups
        x = self.alphabet_size - 1
        table = np.full(256, x, dtype=np.uint8)
        for ridx, group in enumerate(groups):
            for aa in group:
                table[ord(aa)] = ridx
                table[ord(aa.lower())] = ridx
        # ambiguity codes as in setupLetterMapping
        for amb, target in (("J", "L"), ("Z", "E"), ("B", "D")):
            t = table[ord(target)] if target in base.alphabet else x
            table[ord(amb)] = t
            table[ord(amb.lower())] = t
        return table

    def make_aa2num_table(self) -> np.ndarray:
        return self._enc_table

    def encode(self, seq: bytes) -> np.ndarray:
        return self._enc_table[np.frombuffer(seq, dtype=np.uint8)]


_CACHE = {}


def get_reduced(name: str, reduced_size: int, bit_factor: float = 2.0):
    key = (name, reduced_size, bit_factor)
    if key not in _CACHE:
        base = get_submat(name, bit_factor, -0.2)
        _CACHE[key] = ReducedMatrix(base, reduced_size, bit_factor)
    return _CACHE[key]
