"""Database type constants and .dbtype file helpers.

Byte-level contract: `.dbtype` is a 4-byte little-endian integer; the low 16 bits
hold the base type and the high 16 bits hold extended flags
(reference: src/commons/Parameters.h:69-95, src/commons/DBReader.h:405-418).
"""

import os
import struct

# Base database types (reference src/commons/Parameters.h:69-88)
DBTYPE_AMINO_ACIDS = 0
DBTYPE_NUCLEOTIDES = 1
DBTYPE_HMM_PROFILE = 2
# 3 was profile state; removed upstream
DBTYPE_ALIGNMENT_RES = 5
DBTYPE_CLUSTER_RES = 6
DBTYPE_PREFILTER_RES = 7
DBTYPE_TAXONOMICAL_RESULT = 8
DBTYPE_INDEX_DB = 9
DBTYPE_CA3M_DB = 10
DBTYPE_MSA_DB = 11
DBTYPE_GENERIC_DB = 12
DBTYPE_OMIT_FILE = 13
DBTYPE_PREFILTER_REV_RES = 14
DBTYPE_OFFSETDB = 15
DBTYPE_DIRECTORY = 16
DBTYPE_FLATFILE = 17
DBTYPE_SEQTAXDB = 18
DBTYPE_STDIN = 19
DBTYPE_URI = 20

# Extended type flags, high 16 bits (reference src/commons/Parameters.h:91-95)
DBTYPE_EXTENDED_COMPRESSED = 1
DBTYPE_EXTENDED_INDEX_NEED_SRC = 2
DBTYPE_EXTENDED_CONTEXT_PSEUDO_COUNTS = 4
DBTYPE_EXTENDED_GPU = 8
DBTYPE_EXTENDED_SET = 16

# Per-entry zstd compression is flagged by BIT 31 of the whole 4-byte word,
# not by an extended flag (reference src/commons/DBReader.cpp:1122-1124,
# src/util/compress.cpp:26). In our (base, extended) split that is bit 15 of
# the high half.
COMPRESSED_BIT_IN_EXTENDED = 0x8000


def pack_dbtype(base: int, extended: int = 0) -> bytes:
    return struct.pack("<HH", base & 0xFFFF, extended & 0xFFFF)


def unpack_dbtype(raw: bytes):
    base, extended = struct.unpack("<HH", raw[:4])
    return base, extended


def write_dbtype(db_path: str, base: int, extended: int = 0) -> None:
    with open(db_path + ".dbtype", "wb") as f:
        f.write(pack_dbtype(base, extended))


def read_dbtype(db_path: str):
    """Return (base, extended) for a db path, or (-1, 0) if missing."""
    p = db_path + ".dbtype"
    if not os.path.exists(p):
        return -1, 0
    with open(p, "rb") as f:
        raw = f.read(4)
    if len(raw) < 4:
        return -1, 0
    return unpack_dbtype(raw)


def is_seq_dbtype(base: int) -> bool:
    return base in (DBTYPE_AMINO_ACIDS, DBTYPE_NUCLEOTIDES, DBTYPE_HMM_PROFILE)
