"""Writer for the MMseqs2-compatible database format.

Produces a single data file plus text index, sorted by key, and a `.dbtype`
file — byte-compatible with what the reference DBWriter emits after merge
(reference: src/commons/DBWriter.{h,cpp}).
"""

import os

from . import dbtype as dbt


class DBWriter:
    """Single-writer equivalent of the reference multi-threaded DBWriter.

    Entries may be appended in any key order; `close()` writes the index
    sorted by key. Data entries are written in append order.
    """

    def __init__(self, data_path: str, base_type: int = dbt.DBTYPE_GENERIC_DB,
                 extended_type: int = 0, compressed: bool = False):
        self.data_path = data_path
        self.index_path = data_path + ".index"
        self.base_type = base_type
        # the compressed bit describes *this* writer's output, never inherited
        self.extended_type = extended_type & ~dbt.COMPRESSED_BIT_IN_EXTENDED
        self.compressed = compressed
        self._cctx = None
        if compressed:
            import zstandard

            # level 3 streaming frames, matching the reference's
            # ZSTD_initCStream(cLevel=3) (src/commons/DBWriter.cpp:273).
            self._cctx = zstandard.ZstdCompressor(level=3)
            self.extended_type |= dbt.COMPRESSED_BIT_IN_EXTENDED
        # never truncate THROUGH a symlink (createsubdb soft-links ancillary
        # files to the source DB; overwriting must replace the link, not the
        # link target)
        for p in (data_path, self.index_path, data_path + ".dbtype"):
            if os.path.islink(p):
                os.unlink(p)
        self._f = open(data_path, "wb")
        self._entries = []  # (key, offset, length)
        self._offset = 0

    def write(self, key: int, payload: bytes, add_null: bool = True,
              index_len: int = None) -> None:
        """Write one entry. `payload` should already end with '\\n' for text
        records; a '\\0' terminator is appended (counted in the stored length,
        matching the reference). `index_len` overrides the recorded length
        (used by the GPU-padded format, reference makepaddedseqdb.cpp:97-101,
        where the index holds L+2 but the data holds the aligned length)."""
        if self.compressed:
            # Entry layout: [u32 cSize][zstd frame or raw][0x00|0xFF]; index
            # length records the UNCOMPRESSED size + 1 terminator
            # (reference src/commons/DBWriter.cpp:283-398). Entries < 60
            # bytes are stored raw with terminator 0xFF.
            if len(payload) < 60:
                blob, term = payload, b"\xff"
            else:
                cobj = self._cctx.compressobj()
                blob, term = cobj.compress(payload) + cobj.flush(), b"\0"
            self._f.write(len(blob).to_bytes(4, "little"))
            self._f.write(blob)
            self._f.write(term)
            self._entries.append((key, self._offset, len(payload) + 1))
            self._offset += 4 + len(blob) + 1
            return
        self._f.write(payload)
        n = len(payload)
        if add_null:
            self._f.write(b"\0")
            n += 1
        self._entries.append((key, self._offset,
                              n if index_len is None else index_len))
        self._offset += n

    def close(self, sort_by_key: bool = True) -> None:
        self._f.close()
        entries = self._entries
        if sort_by_key:
            entries = sorted(entries, key=lambda e: e[0])
        with open(self.index_path, "w") as f:
            f.write("".join(f"{k}\t{o}\t{l}\n" for k, o, l in entries))
        dbt.write_dbtype(self.data_path, self.base_type, self.extended_type)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_lookup(db_path: str, entries) -> None:
    """entries: iterable of (key, accession, file_number)."""
    if os.path.islink(db_path + ".lookup"):
        os.unlink(db_path + ".lookup")
    with open(db_path + ".lookup", "w") as f:
        f.write("".join(f"{k}\t{a}\t{n}\n" for k, a, n in entries))


def write_source(db_path: str, sources) -> None:
    """sources: iterable of (file_number, file_name)."""
    if os.path.islink(db_path + ".source"):
        os.unlink(db_path + ".source")
    with open(db_path + ".source", "w") as f:
        f.write("".join(f"{i}\t{name}\n" for i, name in sources))


def remove_db(db_path: str) -> None:
    """rmdb equivalent: remove data, index, dbtype, lookup, source files."""
    candidates = [db_path, db_path + ".index", db_path + ".dbtype",
                  db_path + ".lookup", db_path + ".source"]
    i = 0
    while os.path.exists(f"{db_path}.{i}"):
        candidates.append(f"{db_path}.{i}")
        i += 1
    for p in candidates:
        if os.path.exists(p):
            os.remove(p)
