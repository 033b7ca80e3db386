"""Shared helpers for compute commands: DB opening, sequence encoding."""

import numpy as np

from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..utils import log


def open_seq_db(path: str) -> DBReader:
    r = DBReader(path)
    if not dbt.is_seq_dbtype(r.base_type):
        log.warning(f"{path} is not a sequence database (type {r.base_type})")
    return r


class EncodedDB:
    """A sequence DB with residues pre-encoded to numeric indices.

    The encoded sequences are the inputs to the device kernels; encoding is a
    one-shot vectorized byte-table lookup over the whole data file.
    """

    def __init__(self, reader: DBReader, submat):
        self.reader = reader
        self.submat = submat
        self.keys = reader.keys
        self.size = reader.size
        self._cache = {}

    def seq_num(self, idx: int) -> np.ndarray:
        s = self._cache.get(idx)
        if s is None:
            s = self.submat.encode(self.reader.get_seq(idx))
            self._cache[idx] = s
        return s

    def seq_len(self, idx: int) -> int:
        return self.reader.get_seq_len(idx)


def get_sub_mat(par, nucl: bool = False, bit_factor: float = 2.0,
                score_bias: float = 0.0):
    name = par.sub_mat.nucl if nucl else par.sub_mat.aa
    return get_submat(name, bit_factor, score_bias)


import re

_INT_RE = re.compile(rb"^-?\d+")


def fast_atoi(tok: bytes) -> int:
    """Util::fast_atoi: parse the leading integer, ignore the rest (so an
    alignment record's float columns don't crash prefilter-hit parsing)."""
    m = _INT_RE.match(tok)
    return int(m.group(0)) if m else 0


def parse_prefilter_entry(data: bytes):
    """Parse one prefilter DB entry into (keys, scores, diagonals) arrays."""
    keys, scores, diags = [], [], []
    for line in data.split(b"\n"):
        if not line:
            continue
        parts = line.split(b"\t")
        keys.append(fast_atoi(parts[0]))
        scores.append(fast_atoi(parts[1]) if len(parts) > 1 else 0)
        diags.append(fast_atoi(parts[2]) if len(parts) > 2 else 0)
    return keys, scores, diags
