"""FASTA/FASTQ parsing (kseq-equivalent) with gzip/bzip2 support.

Reference behavior: src/commons/KSeqWrapper.{h,cpp} — sequences keep their
original character case; headers are the full line after '>' (including
trailing spaces), comment included.
"""

import bz2
import gzip
import io


def _open_auto(path: str):
    if path == "stdin":
        import sys

        return sys.stdin.buffer
    with open(path, "rb") as probe:
        magic = probe.read(4)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")
    if magic[:3] == b"BZh":
        return bz2.open(path, "rb")
    if magic[:4] == b"\x28\xb5\x2f\xfd":
        import zstandard

        return zstandard.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str):
    """Yield (header, sequence) pairs.

    header: full header line after '>' or '@' without the newline.
    sequence: concatenated sequence bytes, no whitespace.
    FASTQ quality lines are skipped.
    """
    f = _open_auto(path)
    try:
        buf = io.BufferedReader(f) if not isinstance(f, io.BufferedReader) else f
        header = None
        seq_parts = []
        is_fastq = False
        line_iter = iter(buf)
        for line in line_iter:
            line = line.rstrip(b"\r\n")
            if not line and header is None:
                continue
            if line.startswith(b">") or line.startswith(b"@"):
                if header is not None:
                    yield header, b"".join(seq_parts)
                is_fastq = line.startswith(b"@")
                header = line[1:]
                seq_parts = []
            elif line.startswith(b"+") and is_fastq:
                # FASTQ separator; the quality line follows — read exactly the
                # sequence length worth of quality characters
                seq_len = sum(len(p) for p in seq_parts)
                got = 0
                for qline in line_iter:
                    got += len(qline.rstrip(b"\r\n"))
                    if got >= seq_len:
                        break
            else:
                seq_parts.append(line)
        if header is not None:
            yield header, b"".join(seq_parts)
    finally:
        if hasattr(f, "close"):
            f.close()


# FASTA header accession extraction (reference src/commons/Util.cpp
# getFastaHeaderPosition/parseFastaHeader): recognize NCBI-style prefixes and
# return the accession between the pipe characters, else the first word.
_DBS = [
    (b"cl|", 1), (b"sp|", 1), (b"tr|", 1), (b"gb|", 1), (b"ref|", 1),
    (b"pdb|", 1), (b"bbs|", 1), (b"lcl|", 1), (b"pir||", 1), (b"prf||", 1),
    (b"gnl|", 2), (b"pat|", 2), (b"gi|", 3),
]


def parse_fasta_header(header: bytes) -> bytes:
    """Extract the sequence accession from a FASTA header (first word)."""
    word = header.split()[0] if header.split() else b""
    if not word:
        return b""
    h = word
    off = 0
    if h.startswith(b"consensus_"):
        off = 10
    for prefix, bar_pos in _DBS:
        if h[off:].startswith(prefix):
            start = off + len(prefix)
            for _ in range(bar_pos - 1):
                nxt = h.find(b"|", start)
                if nxt == -1:
                    break
                start = nxt + 1
            end = h.find(b"|", start)
            if end == -1:
                end = len(h)
            return h[start:end]
    return word
