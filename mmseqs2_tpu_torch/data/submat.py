"""Substitution matrix model: parsing, probability reconstruction, integerization.

Numerical contract (reference src/commons/SubstitutionMatrix.cpp,
src/commons/BaseMatrix.cpp:110-190):

  1. The .out file holds half-bit float scores S, a precomputed background pBack
     and lambda (in half-bit units, e.g. ln(2)/2 for exact half-bit matrices).
  2. If X scores are not positive, pBack[i] *= (1 - pBack[X]) for i != X.
  3. probMatrix[i][j] = exp(lambda * S[i][j]) * pBack[i] * pBack[j].
  4. A fresh background is computed as row sums of probMatrix, with
     pBack2[X] = ANY_BACK = 1e-5 (BaseMatrix::computeBackground).
  5. float score matrix sm[i][j] = log2(prob[i][j] / (pBack2[i]*pBack2[j])).
  6. integer scores = round-half-away-from-zero(bitFactor * sm + scoreBias)
     (bitFactor 2.0 for alignment/ungapped matrices, 8.0 for k-mer seed matrices).
"""

import math

import numpy as np

from .matrices_data import MATRICES

ANY_BACK = 1e-5  # reference src/commons/BaseMatrix.h


def get_matrix_text(name: str) -> str:
    """Matrix file content by basename (e.g. 'blosum62.out')."""
    if name in MATRICES:
        return MATRICES[name]
    # allow real file paths too
    with open(name) as f:
        return f.read()


class SubstitutionMatrix:
    def __init__(self, name: str = "blosum62.out", bit_factor: float = 2.0,
                 score_bias: float = 0.0):
        self.name = name.split("/")[-1]
        self.bit_factor = bit_factor
        self.score_bias = score_bias
        text = get_matrix_text(name)
        self._parse(text)
        self._build(bit_factor, score_bias)

    # -- parsing ---------------------------------------------------------------

    def _parse(self, text: str):
        lambda_ = None
        back = None
        rows = {}
        alphabet = None
        for line in text.splitlines():
            if line.startswith("#"):
                if line.startswith("# Background (precomputed optional):"):
                    back = np.array([float(w) for w in line.split()[4:]])
                elif line.startswith("# Lambda     (precomputed optional):"):
                    lambda_ = float(line.split()[4])
                continue
            words = line.split()
            if len(words) <= 1:
                continue
            if alphabet is None:
                alphabet = [w[0].upper() for w in words]
                continue
            aa = words[0][0].upper()
            rows[aa] = np.array([float(w) for w in words[1:]])
        if alphabet is None or "X" not in alphabet:
            raise ValueError(f"Matrix {self.name}: missing alphabet header or X")
        self.alphabet = "".join(alphabet)
        self.alphabet_size = len(alphabet)
        self.num2aa = alphabet
        self.aa2num = {a: i for i, a in enumerate(alphabet)}
        S = np.zeros((self.alphabet_size, self.alphabet_size))
        for aa, vals in rows.items():
            S[self.aa2num[aa]] = vals
        if lambda_ is None or back is None:
            from .lambda_calc import estimate_lambda_and_background

            x_idx = self.aa2num["X"]
            x_positive = bool((S[x_idx] > 0).any() or (S[:, x_idx] > 0).any())
            n = self.alphabet_size if x_positive else self.alphabet_size - 1
            lambda_, back_est = estimate_lambda_and_background(S[:n, :n])
            back = np.zeros(self.alphabet_size)
            back[:n] = back_est
            back[x_idx] = ANY_BACK
        self.lambda_file = lambda_
        self._S_halfbit = S
        self._pback_file = np.asarray(back, dtype=np.float64)

    # -- probability + score construction ---------------------------------------

    def _build(self, bit_factor: float, score_bias: float):
        n = self.alphabet_size
        S = self._S_halfbit
        x_idx = self.aa2num["X"]
        x_positive = bool((S[x_idx] > 0).any() or (S[:, x_idx] > 0).any())
        pback = self._pback_file.copy()
        if not x_positive:
            mask = np.arange(n) != x_idx
            pback[mask] = pback[mask] * (1.0 - pback[x_idx])
        prob = np.exp(self.lambda_file * S) * pback[:, None] * pback[None, :]
        self.prob_matrix = prob
        # the member pBack stays the (X-adjusted) file background — it feeds
        # composition bias and tantan likelihood ratios
        # (SubstitutionMatrix::readProbMatrix keeps this->pBack; the row-sum
        # background below is local to generateSubMatrix)
        self.pback = pback
        # recomputed background (BaseMatrix::computeBackground)
        pb2 = prob.sum(axis=1)
        pb2[n - 1] = ANY_BACK  # containsX assumed; X is last by convention
        self.pback_bg = pb2
        # pseudo-count conditionals P(a|b)
        self.sub_matrix_pseudo_counts = prob / pb2[None, :]
        with np.errstate(divide="ignore"):
            sm = np.log2(prob / (pb2[:, None] * pb2[None, :]))
        self.sub_matrix_float = sm
        scaled = bit_factor * sm + score_bias
        # zero-probability cells give -inf log-odds; clamp to a large negative
        # score instead of relying on the C cast's undefined behavior
        scaled = np.where(np.isfinite(scaled), scaled, -(1 << 14))
        # round half away from zero (reference BaseMatrix.cpp:184: +-0.5 trunc)
        self.sub_matrix = np.where(
            scaled < 0.0, scaled - 0.5, scaled + 0.5
        ).astype(np.int16)

    # -- sequence mapping --------------------------------------------------------

    def make_aa2num_table(self) -> np.ndarray:
        """256-entry byte -> residue-index table; unknown letters map to X.

        Mirrors SubstitutionMatrix::setupLetterMapping semantics: known amino
        acid letters map to their index, everything else to X; lowercase maps
        like uppercase.
        """
        x = self.aa2num["X"]
        table = np.full(256, x, dtype=np.uint8)
        for aa, idx in self.aa2num.items():
            table[ord(aa)] = idx
            table[ord(aa.lower())] = idx
        # ambiguity codes (reference SubstitutionMatrix::setupLetterMapping):
        # J->L, Z->E, B->D, U/O->X, everything else ->X
        for amb, target in (("J", "L"), ("Z", "E"), ("B", "D")):
            if target in self.aa2num:
                table[ord(amb)] = self.aa2num[target]
                table[ord(amb.lower())] = self.aa2num[target]
        return table

    def encode(self, seq: bytes) -> np.ndarray:
        """ASCII sequence -> residue indices (uint8)."""
        table = getattr(self, "_enc_table", None)
        if table is None:
            table = self.make_aa2num_table()
            self._enc_table = table
        return table[np.frombuffer(seq, dtype=np.uint8)]

    def decode(self, num: np.ndarray) -> bytes:
        return bytes(bytearray(ord(self.num2aa[i]) for i in num))


class NucleotideMatrix(SubstitutionMatrix):
    """5-letter ACTGX matrix with the nucleotide ambiguity-code mapping and
    reverse-complement lookup (reference src/commons/NucleotideMatrix.cpp)."""

    def make_aa2num_table(self) -> np.ndarray:
        x = self.aa2num["X"]
        table = np.full(256, x, dtype=np.uint8)
        groups = {
            "A": "Aa", "T": "TtUuWw", "G": "GgKkBbDdVvRrSs",
            "C": "CcMmYyHh",
        }
        for base, letters in groups.items():
            for ch in letters:
                table[ord(ch)] = self.aa2num[base]
        return table

    @property
    def reverse_lookup(self) -> np.ndarray:
        rl = getattr(self, "_revlut", None)
        if rl is None:
            rl = np.arange(self.alphabet_size, dtype=np.uint8)
            for a, b in (("A", "T"), ("G", "C")):
                rl[self.aa2num[a]] = self.aa2num[b]
                rl[self.aa2num[b]] = self.aa2num[a]
            self._revlut = rl
        return rl

    def reverse_complement(self, num: np.ndarray) -> np.ndarray:
        return self.reverse_lookup[np.asarray(num, dtype=np.uint8)][::-1]


_CACHE = {}


def get_submat(name: str = "blosum62.out", bit_factor: float = 2.0,
               score_bias: float = 0.0) -> SubstitutionMatrix:
    key = (name, bit_factor, score_bias)
    if key not in _CACHE:
        cls = (NucleotideMatrix if "nucleotide" in name
               else SubstitutionMatrix)
        _CACHE[key] = cls(name, bit_factor, score_bias)
    return _CACHE[key]
