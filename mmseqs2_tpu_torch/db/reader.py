"""Reader for the MMseqs2-compatible on-disk key-value database format.

Format contract (byte compatible with the reference implementation):
  - data file(s): concatenated entries, each terminated by '\\0'. Sequence entries
    end with "...SEQ\\n\\0" so entry length - 2 == sequence length
    (reference: src/prefiltering/ungappedprefilter.cpp:134).
  - data may live in one file `name` or in multiple files `name.0`..`name.N`;
    index offsets address the logical concatenation
    (reference: src/commons/DBReader.cpp openData handling).
  - index file `name.index`: one line per entry, "key\\toffset\\tlength\\n",
    sorted by key (reference: src/commons/DBReader.cpp:904-941).
  - `.dbtype`: 4-byte LE type (see dbtype.py).
  - `.lookup`: "key\\taccession\\tfileNumber\\n" (reference src/commons/DBReader.cpp:1146).
  - `.source`: "fileNumber\\tfileName\\n".
Compressed (zstd per entry) databases carry the DBTYPE_EXTENDED_COMPRESSED flag.
"""

import mmap
import os

import numpy as np

from . import dbtype as dbt
from ..utils import log


class DBReader:
    """Random access reader over data+index, mirroring reference DBReader<unsigned int>."""

    def __init__(self, data_path: str, index_path: str = None, data_mode: str = "rb"):
        self.data_path = data_path
        self.index_path = index_path or (data_path + ".index")
        self.base_type, self.extended_type = dbt.read_dbtype(data_path)
        self.compressed = bool(self.extended_type & dbt.COMPRESSED_BIT_IN_EXTENDED)
        self._zstd = None
        if self.compressed:
            import zstandard  # stdlib-absent; gate hard if unavailable

            self._zstd = zstandard.ZstdDecompressor()

        # index
        self.keys, self.offsets, self.lengths = self._read_index(self.index_path)
        self.size = len(self.keys)
        # dense key optimization: if keys == 0..N-1, id lookup is identity
        self._dense = bool(
            self.size > 0
            and self.keys[0] == 0
            and self.keys[-1] == self.size - 1
        )

        # data files
        self._files = []
        self._maps = []
        self._file_starts = None
        self._open_data()

    # -- construction helpers -------------------------------------------------

    @staticmethod
    def _read_index(index_path: str):
        with open(index_path, "rb") as f:
            raw = f.read()
        if not raw:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        arr = np.frombuffer(raw, dtype=np.uint8)
        # fast vectorized parse: all fields are unsigned decimal ints
        # separated by tabs/newlines
        fields = np.array(raw.split(), dtype=np.int64)
        if fields.size % 3 != 0:
            raise ValueError(f"Malformed index file {index_path}")
        fields = fields.reshape(-1, 3)
        del arr
        keys = np.ascontiguousarray(fields[:, 0])
        offsets = np.ascontiguousarray(fields[:, 1])
        lengths = np.ascontiguousarray(fields[:, 2])
        # writers may emit unsorted indexes (reference DBWriter::close(false,
        # false)); DBReader sorts by key on open (DBReader.cpp sortIndex)
        if len(keys) > 1 and not np.all(keys[1:] >= keys[:-1]):
            order = np.argsort(keys, kind="stable")
            keys, offsets, lengths = keys[order], offsets[order], \
                lengths[order]
        return keys, offsets, lengths

    def _open_data(self):
        paths = []
        if os.path.exists(self.data_path) and os.path.isfile(self.data_path):
            paths = [self.data_path]
        else:
            i = 0
            while os.path.exists(f"{self.data_path}.{i}"):
                paths.append(f"{self.data_path}.{i}")
                i += 1
        if not paths:
            raise FileNotFoundError(f"No data file for {self.data_path}")
        starts = [0]
        for p in paths:
            f = open(p, "rb")
            sz = os.fstat(f.fileno()).st_size
            self._files.append(f)
            if sz > 0:
                self._maps.append(mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ))
            else:
                self._maps.append(b"")
            starts.append(starts[-1] + sz)
        self._file_starts = np.asarray(starts, dtype=np.int64)
        self.data_size = int(starts[-1])

    def close(self):
        for m in self._maps:
            if isinstance(m, mmap.mmap):
                m.close()
        for f in self._files:
            f.close()
        self._maps, self._files = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- lookups ---------------------------------------------------------------

    def get_id(self, key: int) -> int:
        """Internal id for a db key (binary search over sorted keys); -1 if absent."""
        if self._dense:
            return key if 0 <= key < self.size else -1
        i = int(np.searchsorted(self.keys, key))
        if i < self.size and self.keys[i] == key:
            return i
        return -1

    def get_db_key(self, idx: int) -> int:
        return int(self.keys[idx])

    def get_seq_len(self, idx: int) -> int:
        """Sequence length for sequence-type DBs: entry length minus '\\n\\0'."""
        return int(self.lengths[idx]) - 2

    def get_entry_len(self, idx: int) -> int:
        return int(self.lengths[idx])

    def _read_span(self, offset: int, length: int) -> bytes:
        fi = int(np.searchsorted(self._file_starts, offset, side="right")) - 1
        local = offset - int(self._file_starts[fi])
        m = self._maps[fi]
        end = local + length
        if end <= len(m):
            return bytes(m[local:end])
        # span crosses file boundary (shouldn't happen for well-formed DBs)
        out = bytearray(m[local:])
        fi += 1
        while len(out) < length and fi < len(self._maps):
            need = length - len(out)
            out += self._maps[fi][:need]
            fi += 1
        return bytes(out)

    def get_data(self, idx: int) -> bytes:
        """Entry payload *without* the trailing '\\0'."""
        if self.compressed:
            # On-disk entry: [u32 cSize][cSize payload bytes][terminator].
            # terminator 0x00 -> payload is a zstd stream; anything else
            # (reference writes 0xFF for entries < 60 bytes) -> raw payload.
            # The index length holds the UNCOMPRESSED size + 1, so it cannot
            # be used to bound the on-disk read
            # (reference src/commons/DBReader.cpp:584-611,
            #  src/commons/DBWriter.cpp:289-398).
            off = int(self.offsets[idx])
            csize = int.from_bytes(self._read_span(off, 4), "little")
            blob = self._read_span(off + 4, csize + 1)
            payload, term = blob[:csize], blob[csize]
            if term == 0:
                return self._zstd.decompress(
                    payload, max_output_size=max(int(self.lengths[idx]), 64))
            return payload
        raw = self._read_span(int(self.offsets[idx]), int(self.lengths[idx]))
        return raw[:-1] if raw.endswith(b"\0") else raw

    def linear_order(self):
        """Internal ids sorted by data offset — the iteration order of the
        reference's LINEAR_ACCCESS open mode (DBReader.cpp sortIndex), which
        matters for byte parity when entries were written out of key order."""
        return np.argsort(self.offsets, kind="stable")

    def get_data_raw(self, idx: int) -> bytes:
        """Entry payload exactly as stored (no '\\0'-stripping) — for
        binary payloads (prebuilt index buffers) where a trailing zero byte
        is data, not a terminator."""
        return self._read_span(int(self.offsets[idx]),
                               int(self.lengths[idx]))

    def get_data_view(self, idx: int) -> memoryview:
        """Zero-copy memoryview of an entry payload, backed by the mmap.

        Pages fault in lazily on first touch, so np.frombuffer over this
        view makes loading a multi-hundred-MB prebuilt index (.idx)
        effectively free until the buffers are actually read. The view is
        only valid while the reader stays open — callers that outlive the
        reader must keep a reference to it (load_index does)."""
        offset = int(self.offsets[idx])
        length = int(self.lengths[idx])
        fi = int(np.searchsorted(self._file_starts, offset,
                                 side="right")) - 1
        local = offset - int(self._file_starts[fi])
        m = self._maps[fi]
        if local + length <= len(m):
            return memoryview(m)[local:local + length]
        return memoryview(self._read_span(offset, length))

    def get_seq(self, idx: int) -> bytes:
        """Sequence bytes without trailing newline/terminator."""
        d = self.get_data(idx)
        return d[:-1] if d.endswith(b"\n") else d

    def get_data_by_key(self, key: int) -> bytes:
        i = self.get_id(key)
        if i < 0:
            raise KeyError(f"Key {key} not in DB {self.data_path}")
        return self.get_data(i)

    def total_residues(self) -> int:
        """getAminoAcidDBSize (DBReader.cpp:613-621): sum(length-2) for
        sequences; profile DBs count columns (dataSize/25 - size)."""
        from . import dbtype as dbt
        if self.base_type == dbt.DBTYPE_HMM_PROFILE:
            return int(self.lengths.sum()) // 25 - self.size
        return int(self.lengths.sum()) - 2 * self.size

    def __len__(self):
        return self.size

    def __iter__(self):
        for i in range(self.size):
            yield int(self.keys[i]), self.get_data(i)

    # -- auxiliary tables -------------------------------------------------------

    def read_lookup(self):
        """Return dict key -> (accession, file_number)."""
        path = self.data_path + ".lookup"
        out = {}
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            for line in f:
                parts = line.rstrip(b"\n").split(b"\t")
                if len(parts) >= 3:
                    out[int(parts[0])] = (parts[1].decode(), int(parts[2]))
        return out


def open_header_db(db_path: str) -> DBReader:
    return DBReader(db_path + "_h")
