"""Profile DB entry parsing (DBTYPE_HMM_PROFILE).

Port of mmseqs2_tpu/profile/io.py.
Reference: Sequence::mapProfile (src/commons/Sequence.cpp) — 25 bytes per
position: 20 int8 scores (8-bit scale), query letter, consensus letter, Neff
byte, 2 gap bytes. The alignment-scale profile is scores/4 (C truncation)
with the X row zeroed.
"""

import numpy as np

from .mathx import fpow2

PROFILE_READIN_SIZE = 25
PROFILE_AA_SIZE = 20


class ProfileEntry:
    __slots__ = ("scores", "query_num", "consensus_num", "neff", "length")


def parse_profile(data: bytes) -> ProfileEntry:
    arr = np.frombuffer(data, dtype=np.uint8)
    L = len(arr) // PROFILE_READIN_SIZE
    arr = arr[: L * PROFILE_READIN_SIZE].reshape(L, PROFILE_READIN_SIZE)
    p = ProfileEntry()
    p.length = L
    p.scores = arr[:, :PROFILE_AA_SIZE].view(np.int8).copy()   # (L, 20)
    p.query_num = arr[:, 20].copy()
    p.consensus_num = arr[:, 21].copy()
    p.neff = fpow2((arr[:, 22].astype(np.float32) - np.float32(1.0))
                   / np.float32(64.0))
    return p


def alignment_profile(p: ProfileEntry, alpha_pad: int = 32,
                      alphabet_size: int = 21) -> np.ndarray:
    """(alpha_pad, L) int32 column-score matrix at 2-bit scale.

    scores/4 with C truncation toward zero; X row zero; PAD rows very
    negative (mapProfile:29-36).
    """
    L = p.length
    NEG = np.int32(-(1 << 20))
    prof = np.full((alpha_pad, L), NEG, dtype=np.int32)
    s = p.scores.astype(np.int32)
    quarter = np.sign(s) * (np.abs(s) // 4)        # trunc toward zero
    prof[:PROFILE_AA_SIZE, :] = quarter.T
    prof[alphabet_size - 1, :] = 0                 # X scores 0
    return prof


# Batcher sorting network from Util::rankedDescSort20 (src/commons/Util.cpp:118)
# — compare-exchange on strict '<' only, so tie order is the network's wire
# permutation, NOT a stable sort; replicated exactly for k-mer-list parity.
_SWAP_PAIRS = [
    (0, 16), (1, 17), (2, 18), (3, 19), (4, 12), (5, 13), (6, 14), (7, 15),
    (0, 8), (1, 9), (2, 10), (3, 11),
    (8, 16), (9, 17), (10, 18), (11, 19), (0, 4), (1, 5), (2, 6), (3, 7),
    (8, 12), (9, 13), (10, 14), (11, 15), (4, 16), (5, 17), (6, 18), (7, 19),
    (0, 2), (1, 3),
    (4, 8), (5, 9), (6, 10), (7, 11), (12, 16), (13, 17), (14, 18), (15, 19),
    (0, 1),
    (4, 6), (5, 7), (8, 10), (9, 11), (12, 14), (13, 15), (16, 18), (17, 19),
    (2, 16), (3, 17), (6, 12), (7, 13), (18, 19),
    (2, 8), (3, 9), (10, 16), (11, 17),
    (2, 4), (3, 5), (6, 8), (7, 9), (10, 12), (11, 13), (14, 16), (15, 17),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15), (16, 17),
    (1, 16), (3, 18), (5, 12), (7, 14),
    (1, 8), (3, 10), (9, 16), (11, 18),
    (1, 4), (3, 6), (5, 8), (7, 10), (9, 12), (11, 14), (13, 16), (15, 18),
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    (17, 18),
]


def ranked_desc_sort20(scores: np.ndarray):
    """Vectorized rankedDescSort20 over all rows of a (L, 20) score array.

    Returns (sorted_scores desc, letter indices) with the reference network's
    exact tie ordering."""
    val = scores.astype(np.int32).copy()
    idx = np.broadcast_to(np.arange(20, dtype=np.int64),
                          val.shape).copy()
    for x, y in _SWAP_PAIRS:
        swap = val[:, x] < val[:, y]
        vx = val[swap, x].copy()
        val[swap, x] = val[swap, y]
        val[swap, y] = vx
        ix = idx[swap, x].copy()
        idx[swap, x] = idx[swap, y]
        idx[swap, y] = ix
    return val, idx


def kmer_rows(p: ProfileEntry):
    """Per-position (scores desc, letter indices) for the k-mer generator
    (Sequence::mapProfile sorting loop, Sequence.cpp:345-352)."""
    return ranked_desc_sort20(p.scores.astype(np.int32))
