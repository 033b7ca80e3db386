"""Compressed A3M (ca3m) codec.

Port of mmseqs2_tpu/profile/ca3m.py.

Binary MSA format from HH-suite/MMseqs2: an entry is a FASTA-ish text head
(optional '#' commentary line, '>header\\n<consensus-or-master-seq>\\n'),
a ';' marker, then a sequence of binary hit records:

    [u32 local-id][u16 startPos(1-based)][u16 nBlocks]
        { [u8 matchLen][i8 indel] } * nBlocks

where indel > 0 means lowercase insertions (relative to the master) and
indel < 0 means gaps.  Local ids index the *concatenated* sequence DB built
by DBConcat, not db keys.

Reference: src/alignment/CompressedA3M.cpp (extractA3M :59-167,
extractMatcherResults :169-290, hitToBuffer :293-383).
"""

import struct


def extract_a3m(data: bytes, seq_reader, hdr_reader) -> bytes:
    """Decode a ca3m entry into a full A3M text block
    (reference CompressedA3M::extractA3M).

    `data` is the entry payload without the trailing '\\0'; `seq_reader` and
    `hdr_reader` are DBReaders over the concatenated sequence/header DBs
    (local ids = row indices).
    """
    out = bytearray()
    index = 0
    size = len(data)
    # optional commentary line
    if index < size and data[index:index + 1] == b"#":
        nl = data.find(b"\n", index)
        nl = size if nl < 0 else nl
        out += data[index:nl] + b"\n"
        index = nl + 1
    # copy text head until a line starting with ';'
    consensus_length = 0
    in_consensus = 0
    last = b"\n" if out.endswith(b"\n") else b"\0"
    while index < size and not (last == b"\n" and data[index:index + 1] == b";"):
        c = data[index:index + 1]
        if c == b"\n":
            in_consensus += 1
        elif in_consensus == 1:
            consensus_length += 1
        out += c
        last = c
        index += 1
    index += 1  # past ';'

    lower = bytes.maketrans(
        bytes(range(65, 91)), bytes(range(97, 123)))
    while index < size:
        entry_index, start_pos, nr_blocks = struct.unpack_from(
            "<IHH", data, index)
        index += 8
        sequence = seq_reader.get_data(int(entry_index))
        header = hdr_reader.get_data(int(entry_index))
        if not header.startswith(b">"):
            out += b">"
        out += header[:-1] if header.endswith(b"\n") else header
        out += b"\n"
        pos = start_pos
        aln_len = 0
        for _ in range(nr_blocks):
            nr_matches = data[index]
            index += 1
            out += sequence[pos - 1:pos - 1 + nr_matches]
            pos += nr_matches
            aln_len += nr_matches
            indel = struct.unpack_from("<b", data, index)[0]
            index += 1
            if indel > 0:
                out += sequence[pos - 1:pos - 1 + indel].translate(lower)
                pos += indel
            else:
                out += b"-" * (-indel)
                aln_len += -indel
        if aln_len < consensus_length:
            out += b"-" * (consensus_length - aln_len)
        out += b"\n"
    return bytes(out)


def extract_matcher_results(data: bytes, seq_reader, skip_first: bool):
    """Decode a ca3m entry into (query_key, [hit dicts]) with alignment
    coordinates and an M/I/D backtrace
    (reference CompressedA3M::extractMatcherResults).

    Hit dicts carry db_key/q_start/q_end/q_len/db_start/db_end/db_len/
    backtrace; score/seq_id/evalue are zeroed like the reference.
    """
    index = 0
    size = len(data)
    if index < size and data[index:index + 1] == b"#":
        nl = data.find(b"\n", index)
        index = (size if nl < 0 else nl) + 1
    last = b"\0"
    while index < size and not (last == b"\n" and data[index:index + 1] == b";"):
        last = data[index:index + 1]
        index += 1
    index += 1

    key = None
    q_len = 0
    results = []
    first = True
    while index < size:
        entry_index, start_pos, nr_blocks = struct.unpack_from(
            "<IHH", data, index)
        index += 8
        db_key = seq_reader.get_db_key(int(entry_index))
        if first:
            key = db_key
            q_len = seq_reader.get_seq_len(int(entry_index))
            db_len = q_len
        else:
            db_len = seq_reader.get_seq_len(int(entry_index))
        if skip_first and first:
            index += 2 * nr_blocks
            first = False
            continue
        first = False
        q_start = 0
        q_aln = 0
        db_aln = 0
        first_block_m = False
        bt = bytearray()
        for _ in range(nr_blocks):
            match_count = data[index]
            index += 1
            q_aln += match_count
            db_aln += match_count
            bt += b"M" * match_count
            if match_count != 0:
                first_block_m = True
            indel = struct.unpack_from("<b", data, index)[0]
            index += 1
            if not first_block_m:
                q_start -= indel
            elif indel > 0:
                bt += b"D" * indel
                q_aln += indel
            elif indel < 0:
                bt += b"I" * (-indel)
                db_aln -= indel
        results.append({
            "db_key": db_key, "score": 0, "seq_id": 0.0, "evalue": 0.0,
            "q_start": q_start, "q_end": q_start + db_aln - 1, "q_len": q_len,
            "db_start": start_pos - 1, "db_end": start_pos - 1 + q_aln - 1,
            "db_len": db_len, "backtrace": bt.decode(),
        })
    return key, results


def hit_to_buffer(target_local_id: int, q_start: int, db_start: int,
                  backtrace: str) -> bytes:
    """Encode one hit as a ca3m binary record
    (reference CompressedA3M::hitToBuffer)."""
    out = bytearray(struct.pack("<IH", target_local_id, db_start + 1))
    n_blocks = 0
    blocks = bytearray()
    # leading deletions for the unaligned query prefix, 127 at a time
    first_gap = q_start
    while first_gap:
        gap = min(127, first_gap)
        blocks += struct.pack("<Bb", 0, -gap)
        first_gap -= gap
        n_blocks += 1
    i = 0
    n = len(backtrace)
    while i < n:
        match_len = 0
        while i < n and backtrace[i] == "M" and match_len < 255:
            i += 1
            match_len += 1
        blocks.append(match_len)
        in_or_del = None
        if i < n and backtrace[i] != "M":
            in_or_del = backtrace[i]
        indel_len = 0
        while i < n and backtrace[i] == in_or_del and indel_len < 127:
            i += 1
            indel_len += 1
        if indel_len and in_or_del == "I":
            indel_len = -indel_len
        blocks += struct.pack("<b", indel_len)
        n_blocks += 1
    out += struct.pack("<H", n_blocks)
    out += blocks
    return bytes(out)
